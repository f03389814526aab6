#!/bin/sh
# Cross-dataset generalisation sweep (mirrors reference scripts/
# cross_ft_lp_eval.sh): extract features with encoders FINE-TUNED on one task,
# linear-probe them on every heart task. Fill in the best-seed FT checkpoint
# paths (cks/finetune/<task>/finetuning_*-valid_auc=*.pt).

pretrain_model=operaCT
dim=768

pairs="
circor_murmurs:[insert_ckpt_path]:0
circor_outcomes:[insert_ckpt_path]:0
pascal_A:[insert_ckpt_path]:3
pascal_B:[insert_ckpt_path]:2
physionet16:[insert_ckpt_path]:0
zchsound_clean:[insert_ckpt_path]:3
zchsound_clean_murmurs:[insert_ckpt_path]:2
zchsound_noisy:[insert_ckpt_path]:2
zchsound_noisy_murmurs:[insert_ckpt_path]:3
"

echo starting feature extractions
for pair in $pairs; do
  fine_tuned=$(echo "$pair" | cut -d: -f1)
  ckpt_path=$(echo "$pair" | cut -d: -f2)
  seed=$(echo "$pair" | cut -d: -f3)
  for args in "dataset=circor" "dataset=pascal data=A" "dataset=pascal data=B" \
              "dataset=physionet16" "dataset=zchsound data=clean" "dataset=zchsound data=noisy"; do
    python -m heart_murmur_detection_tpu_torch.cli.process $args \
      pretrain=$pretrain_model dim=$dim seed=$seed \
      fine_tuned=$fine_tuned ckpt_path=$ckpt_path
  done
done

echo starting linear probing evaluations
feats=""
for pair in $pairs; do
  fine_tuned=$(echo "$pair" | cut -d: -f1)
  seed=$(echo "$pair" | cut -d: -f3)
  feats="$feats,${pretrain_model}${dim}_finetuned_${fine_tuned}_${seed}"
done
feats=${feats#,}

python -m heart_murmur_detection_tpu_torch.cli.linear_eval -m \
  task=circor_murmurs,circor_outcomes,pascal_A,pascal_B,physionet16,zchsound_clean,zchsound_clean_murmurs,zchsound_noisy,zchsound_noisy_murmurs \
  pretrain=$feats \
  dim=$dim
