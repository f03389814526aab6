#!/bin/sh
# COPD severity (Task 11) LP evaluation (reference scripts/copd_eval.sh)
python -m heart_murmur_detection_tpu_torch.cli.linear_eval task=copd pretrain=${1:-operaGT} dim=${2:-384}
