#!/bin/sh
# Combined heart benchmark: LP + FT for one pretrain (reference scripts/benchmark.sh)
pretrain_model=$1
dim=$2
sh heart_murmur_detection_tpu_torch/scripts/lp_eval.sh "$pretrain_model" "$dim"
sh heart_murmur_detection_tpu_torch/scripts/ft_eval.sh "$pretrain_model" "$dim"
