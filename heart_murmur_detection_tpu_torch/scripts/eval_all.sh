#!/bin/sh
# Full OPERA 19-task benchmark pipeline (mirrors reference scripts/eval_all.sh)
# usage: sh heart_murmur_detection_tpu_torch/scripts/eval_all.sh operaCT 768

pretrain_model=$1
dim=${2:-0}

# Tasks 1-2: COVID-UK exhalation / cough
python -m heart_murmur_detection_tpu_torch.cli.linear_eval task=coviduk modality=exhalation pretrain=$pretrain_model dim=$dim
python -m heart_murmur_detection_tpu_torch.cli.linear_eval task=coviduk modality=cough pretrain=$pretrain_model dim=$dim
# Tasks 3-4: COVID-19 Sounds breath / cough
python -m heart_murmur_detection_tpu_torch.cli.linear_eval task=covid19sounds modality=breath pretrain=$pretrain_model dim=$dim
python -m heart_murmur_detection_tpu_torch.cli.linear_eval task=covid19sounds modality=cough pretrain=$pretrain_model dim=$dim
# Tasks 5-6: CoughVID covid / sex
python -m heart_murmur_detection_tpu_torch.cli.linear_eval task=coughvidcovid pretrain=$pretrain_model dim=$dim
python -m heart_murmur_detection_tpu_torch.cli.linear_eval task=coughvidsex pretrain=$pretrain_model dim=$dim
# Task 7: ICBHI disease
python -m heart_murmur_detection_tpu_torch.cli.linear_eval task=icbhidisease pretrain=$pretrain_model dim=$dim
# Tasks 8-9: Coswara smoker / sex
python -m heart_murmur_detection_tpu_torch.cli.linear_eval task=coswarasmoker modality=breathing-deep pretrain=$pretrain_model dim=$dim
python -m heart_murmur_detection_tpu_torch.cli.linear_eval task=coswarasex modality=breathing-deep pretrain=$pretrain_model dim=$dim
# Task 10: KAUH
python -m heart_murmur_detection_tpu_torch.cli.linear_eval task=kauh pretrain=$pretrain_model dim=$dim
# Task 11: COPD severity
python -m heart_murmur_detection_tpu_torch.cli.linear_eval task=copd pretrain=$pretrain_model dim=$dim
# Task 12: SSBPR snoring
python -m heart_murmur_detection_tpu_torch.cli.linear_eval task=snoring pretrain=$pretrain_model dim=$dim
# Tasks 13-18: MMLung spirometry LOOCV
for label in FVC FEV1 FEV1_FVC; do
  for modality in breath vowels; do
    python -m heart_murmur_detection_tpu_torch.cli.linear_eval task=spirometry LOOCV=True label=$label modality=$modality head=mlp pretrain=$pretrain_model dim=$dim
  done
done
# Task 19: NoseMic respiratory rate LOOCV
python -m heart_murmur_detection_tpu_torch.cli.linear_eval task=rr LOOCV=True head=mlp pretrain=$pretrain_model dim=$dim
