#!/bin/sh
# Evaluate saved fine-tuned checkpoints, incl. cross-task routing
# (reference scripts/finetune_eval.sh -> eval_ckpts.py).
# usage: sh heart_murmur_detection_tpu_torch/scripts/finetune_eval.sh operaCT 768 circor_murmurs [finetuned_task]

pretrain=$1
dim=$2
task=$3
finetuned_task=${4:-none}

python - "$pretrain" "$dim" "$task" "$finetuned_task" <<'EOF'
import sys
import numpy as np
from heart_murmur_detection_tpu_torch.cli.linear_eval import route_heart_task
from heart_murmur_detection_tpu_torch.train.eval_ckpts import evaluate_finetuned_model

pretrain, dim, task, ft_task = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
ds, t, fdir, labels = route_heart_task(task)
kw = {}
if ft_task != "none":
    fds, ft, _, _ = route_heart_task(ft_task)
    kw = dict(finetuned_dataset_name=fds, finetuned_task=ft)
scores = []
for seed in range(5):
    out = evaluate_finetuned_model(
        seed=seed, pretrain=pretrain, feat_dim=dim, dataset_name=ds, task=t,
        feature_dir=fdir, labels_filename=labels, **kw)
    print(f"seed {seed}: test_auc {out['test_auc']:.4f}")
    scores.append(out["test_auc"])
print(f"mean {np.mean(scores):.3f} ± {np.std(scores):.3f}")
EOF
