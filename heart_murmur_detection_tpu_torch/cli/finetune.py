"""Fine-tuning CLI — counterpart of heart_murmur_detection_tpu/cli/finetune.py
(`main` :14; the reference's finetuning.py main, :1363-1499).

Usage:
  python -m heart_murmur_detection_tpu_torch.cli.finetune task=circor_murmurs pretrain=operaCT compute_dtype=bfloat16 random_init=True

  python -m heart_murmur_detection_tpu_torch.cli.finetune task=circor_murmurs n_run=1   # operaCE
  python -m heart_murmur_detection_tpu_torch.cli.finetune task=circor_murmurs pretrain=clap2023 random_init=True

Reads configs/finetune_config.yaml (its default pretrain is operaCE, the
EfficientNet, whose checkpoint cks/model/encoder-operaCE.ckpt it loads
unless random_init=True; pretrain=null starts it from random weights; clap,
clap2023 and hear take an msclap / google/hear-pytorch state_dict through
ckpt_path= or random_init=True) and feature/<task>_eval/ in the
working directory (a processed heart task: sound_dir_loc, labels, split);
caches the first-window spectrograms there, fine-tunes n_run seeds on the
card (`device=cpu` runs on the CPU; `epochs=N` shortens the 64-epoch
protocol) and prints each seed's test AUROC and the five-seed mean and std.
Best weights land in cks/finetune/<dataset>_<task>/ as state_dict .pt
files. dp, tp and param_sharding (multi-device) raise NotImplementedError.
"""

from __future__ import annotations

import sys

import numpy as np

from ..train.finetune import finetune_heart
from .config import parse_compute_dtype, resolve
from .linear_eval import route_heart_task


def main(argv=None):
    """Runs every resolved config; returns one list of test AUROCs per config."""
    argv = sys.argv[1:] if argv is None else argv
    results = []
    for cfg in resolve("finetune_config", argv):
        if int(cfg.get("dp", 1)) > 1 or int(cfg.get("tp", 1)) > 1 or cfg.get("param_sharding"):
            raise NotImplementedError(
                "multi-device fine-tuning (dp, tp, param_sharding) is not ported yet (slice 6)")
        ds, task, fdir, labels = route_heart_task(cfg["task"])
        # pretrain=null coerces to None (yaml/hydra); downstream string-compares it
        pretrain = "null" if cfg["pretrain"] is None else cfg["pretrain"]
        scores = []
        for seed in range(cfg["n_run"]):
            res = finetune_heart(
                seed=seed,
                pretrain=pretrain,
                epochs=int(cfg.get("epochs", 64)),
                l2_strength=cfg["l2_strength"],
                feat_dim=cfg["dim"],
                dataset_name=ds,
                task=task,
                feature_dir=fdir,
                labels_filename=labels,
                freeze_encoder=cfg["freeze_encoder"],
                loss=cfg["loss"],
                spec_augment=cfg["spec_augment"],
                random_init=cfg.get("random_init", False),
                ckpt_path=cfg.get("ckpt_path"),
                compute_dtype=parse_compute_dtype(cfg),
                device=cfg.get("device", "cuda"),
            )
            print(f"seed {seed}: test_auc {res.test_auc:.4f} (best epoch {res.best_epoch})",
                  flush=True)
            scores.append(res.test_auc)
        print("=" * 48)
        print(scores)
        print(
            f"Five times mean task {cfg['task']} finetuning from {pretrain} "
            f"results: auc mean {np.mean(scores):.3f} ± {np.std(scores):.3f}"
        )
        print("=" * 48)
        results.append(scores)
    return results


if __name__ == "__main__":
    main()
