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
files. dp=N fine-tunes every seed on N ranks (parallel/launch.py;
dist_backend nccl, the default on a card, or gloo, the CPU's default, whose
ranks may share a card; `dp=2 dist_backend=gloo device=cpu` on the CPU), and
param_sharding=fsdp is ZeRO-3 over them. dp=N tp=M runs N x M ranks on a
dp x tp mesh (parallel/mesh.py::mesh_2d), megatron tensor parallelism over
the M model ranks unless param_sharding=fsdp (ZeRO-3 over them), for every
pretrain, e.g. on the CPU:

  python -m heart_murmur_detection_tpu_torch.cli.finetune task=circor_murmurs pretrain=hear random_init=True dp=2 tp=2 dist_backend=gloo device=cpu
"""

from __future__ import annotations

import sys

import numpy as np

from ..parallel.launch import launch
from ..parallel.mesh import mesh_from_cli
from ..train.finetune import finetune_heart
from .config import parse_compute_dtype, resolve
from .linear_eval import route_heart_task


def run_seeds(mesh, cfg: dict, param_sharding=None):
    """The n_run seeds of one config (in every rank of a data-parallel
    run; rank 0 prints): their test AUROCs."""
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
            mesh=mesh,
            param_sharding=param_sharding,
        )
        if mesh is None or mesh.rank == 0:
            print(f"seed {seed}: test_auc {res.test_auc:.4f} (best epoch {res.best_epoch})",
                  flush=True)
        scores.append(res.test_auc)
    return scores


def main(argv=None):
    """Runs every resolved config; returns one list of test AUROCs per config."""
    argv = sys.argv[1:] if argv is None else argv
    results = []
    for cfg in resolve("finetune_config", argv):
        plan, param_sharding = mesh_from_cli(cfg)
        pretrain = "null" if cfg["pretrain"] is None else cfg["pretrain"]
        if plan is None:
            scores = run_seeds(None, cfg)
        else:
            scores = launch(run_seeds, plan.world, cfg, param_sharding, backend=plan.backend,
                            device=cfg.get("device", "cuda"), tp=plan.tp)
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
