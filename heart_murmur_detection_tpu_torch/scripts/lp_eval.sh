#!/bin/sh
# Linear Probing Evaluations (mirrors reference scripts/lp_eval.sh)
# usage: sh heart_murmur_detection_tpu_torch/scripts/lp_eval.sh operaCT 768

pretrain_model=$1
if [ $# -gt 1 ]; then
        dim=$2
        echo 'Feature dimension:' $dim
else
        dim=0
        echo 'Baseline: no need to specify dimension'
fi

echo starting feature extractions

python -m heart_murmur_detection_tpu_torch.cli.process dataset=circor pretrain=$pretrain_model dim=$dim
python -m heart_murmur_detection_tpu_torch.cli.process dataset=pascal data=A pretrain=$pretrain_model dim=$dim
python -m heart_murmur_detection_tpu_torch.cli.process dataset=pascal data=B pretrain=$pretrain_model dim=$dim
python -m heart_murmur_detection_tpu_torch.cli.process dataset=physionet16 pretrain=$pretrain_model dim=$dim
python -m heart_murmur_detection_tpu_torch.cli.process dataset=zchsound data=clean pretrain=$pretrain_model dim=$dim
python -m heart_murmur_detection_tpu_torch.cli.process dataset=zchsound data=noisy pretrain=$pretrain_model dim=$dim

echo starting linear probing evaluations
python -m heart_murmur_detection_tpu_torch.cli.linear_eval -m \
  task=circor_murmurs,circor_outcomes,pascal_A,pascal_B,physionet16,zchsound_clean,zchsound_clean_murmurs,zchsound_noisy,zchsound_noisy_murmurs \
  pretrain=$pretrain_model \
  dim=$dim
