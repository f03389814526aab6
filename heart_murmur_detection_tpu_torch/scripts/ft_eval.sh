#!/bin/sh
# Fine-tuning Evaluations (mirrors reference scripts/ft_eval.sh)
# usage: sh heart_murmur_detection_tpu_torch/scripts/ft_eval.sh operaCT 768

pretrain_model=$1
if [ $# -gt 1 ]; then
        dim=$2
        echo 'Feature dimension:' $dim
else
        echo 'Error: Dimension must be specified'
        exit 1
fi

echo starting fine-tuning
python -m heart_murmur_detection_tpu_torch.cli.finetune -m \
  task=circor_murmurs,circor_outcomes,pascal_A,pascal_B,physionet16,zchsound_clean,zchsound_clean_murmurs,zchsound_noisy,zchsound_noisy_murmurs \
  pretrain=$pretrain_model \
  dim=$dim
