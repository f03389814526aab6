#!/bin/sh
# KAUH (Task 10) LP evaluation (reference scripts/kauh_eval.sh)
python -m heart_murmur_detection_tpu_torch.cli.linear_eval task=kauh pretrain=${1:-operaGT} dim=${2:-384}
