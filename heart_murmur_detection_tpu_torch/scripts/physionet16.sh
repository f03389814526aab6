#!/bin/sh
# physionet16 processing + extraction + LP (reference scripts/physionet16.sh)
pretrain_model=$1
dim=${2:-768}
python -m heart_murmur_detection_tpu_torch.cli.process dataset=physionet16 pretrain=$pretrain_model dim=$dim
python -m heart_murmur_detection_tpu_torch.cli.linear_eval task=physionet16 pretrain=$pretrain_model dim=$dim
