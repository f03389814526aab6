#!/bin/sh
# circor processing + extraction + LP (reference scripts/circor.sh)
pretrain_model=$1
dim=${2:-768}
python -m heart_murmur_detection_tpu_torch.cli.process dataset=circor pretrain=$pretrain_model dim=$dim
python -m heart_murmur_detection_tpu_torch.cli.linear_eval -m task=circor_murmurs,circor_outcomes pretrain=$pretrain_model dim=$dim
