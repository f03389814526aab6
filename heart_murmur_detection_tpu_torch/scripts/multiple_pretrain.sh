#!/bin/sh
# Multi-corpus respiratory SSL pretraining runs (reference scripts/
# multiple_pretrain.sh): the original OPERA recipes over the legacy corpora.

# OPERA-CE (efficientnet COLA) over all respiratory corpora
python -m heart_murmur_detection_tpu_torch.cli.pretrain \
  covidbreath=True covidcough=True icbhi=True coughvid=True hf_lung=True \
  covidUKexhalation=True covidUKcough=True \
  encoder=efficientnet title=operaCE-respiratory epoches=512 method=cola

# OPERA-CT (htsat COLA)
# python -m heart_murmur_detection_tpu_torch.cli.pretrain \
#   covidbreath=True covidcough=True icbhi=True coughvid=True hf_lung=True \
#   covidUKexhalation=True covidUKcough=True \
#   encoder=htsat dim_hidden=768 title=operaCT-respiratory epoches=512 method=cola

# OPERA-GT (mae)
# python -m heart_murmur_detection_tpu_torch.cli.pretrain \
#   covidbreath=True covidcough=True icbhicycle=True coughvid=True hf_lung=True \
#   covidUKexhalation=True covidUKcough=True \
#   title=operaGT-respiratory epoches=512 method=mae
