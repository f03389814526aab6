"""Checkpoint re-evaluation CLI — counterpart of
heart_murmur_detection_tpu/cli/eval_ckpts.py (`_split_finetuned` :22,
`evaluate_one` :34, `main` :71; the reference's eval_ckpts.py:432-516).

Reloads the probe heads (head_only=True) or fine-tuned models the port
saved under cks/ by their hyperparameter-encoded names and re-tests them,
including cross-task evaluation through `finetuned_task` (an encoder
fine-tuned on task A tested on task B's split):

    python -m heart_murmur_detection_tpu_torch.cli.eval_ckpts task=circor_murmurs \\
        pretrain=operaCT dim=768 head_only=False finetuned_task=pascal_A

Reads configs/eval_config.yaml and feature/<task>_eval/ in the working
directory; runs on the card (`device=cpu` on the CPU). `epochs` picks the
checkpoints' epoch count (the config's 64, which the JAX package fixes).
"""

from __future__ import annotations

import sys

import numpy as np

from ..train.eval_ckpts import evaluate_finetuned_model, evaluate_linear_head
from ..train.metrics import expand_per_class
from .config import resolve
from .linear_eval import route_heart_task


def _split_finetuned(finetuned_task: str):
    """'pascal_A' -> ('pascal', 'A'); 'zchsound_clean_murmurs' ->
    ('zchsound_clean', 'murmurs'); bare dataset -> (ds, '')
    (eval_ckpts.py:442-450)."""
    parts = finetuned_task.split("_")
    if len(parts) == 1:
        return parts[0], ""
    if len(parts) == 2:
        return parts[0], parts[1]
    return f"{parts[0]}_{parts[1]}", parts[2]


def evaluate_one(cfg, seed: int) -> float:
    """One seed's re-test; prints the metrics and returns the test AUROC."""
    ds, task, fdir, labels = route_heart_task(cfg["task"])
    # pretrain=null coerces to None; downstream string-compares "null"
    if cfg.get("pretrain") is None:
        cfg = {**cfg, "pretrain": "null"}
    common = dict(
        seed=seed,
        metrics=cfg["metrics"],
        epochs=int(cfg.get("epochs", 64)),
        l2_strength=cfg["l2_strength"],
        batch_size=cfg["batch_size"],
        loss=cfg["loss"],
        dataset_name=ds,
        task=task,
        feature_dir=fdir,
        labels_filename=labels,
        device=cfg.get("device", "cuda"),
    )
    if cfg["head_only"]:
        res = evaluate_linear_head(use_feature=cfg["pretrain"], head="linear", **common)
    else:
        if cfg.get("finetuned_task") not in (None, "none"):
            fds, ft = _split_finetuned(cfg["finetuned_task"])
            common.update(finetuned_dataset_name=fds, finetuned_task=ft)
        res = evaluate_finetuned_model(
            pretrain=cfg["pretrain"],
            head="linear",
            feat_dim=cfg["dim"],
            freeze_encoder=cfg["freeze_encoder"],
            **common,
        )
    for k, v in sorted(expand_per_class(res, ds, task).items()):
        print(f"  {k}: {v:.4f}")
    return float(res["test_auc"])


def main(argv=None):
    """Runs every resolved config; returns one list of test AUROCs per config."""
    argv = sys.argv[1:] if argv is None else argv
    results = []
    for cfg in resolve("eval_config", argv):
        scores = []
        for seed in range(cfg["n_run"]):
            print(f"-- seed {seed} --")
            scores.append(evaluate_one(cfg, seed))
        print("=" * 48)
        print(scores)
        print(
            f"Five times mean task {cfg['task']} eval from {cfg['pretrain']} "
            f"results: auc mean {np.mean(scores):.3f} ± {np.std(scores):.3f}"
        )
        print("=" * 48)
        results.append(scores)
    return results


if __name__ == "__main__":
    main()
