"""Linear-probe evaluation CLI — counterpart of
heart_murmur_detection_tpu/cli/linear_eval.py (`route_heart_task` :21,
`feature_name` :41, `main` :104) for the heart tasks and their grid search.

Usage:
  python -m heart_murmur_detection_tpu_torch.cli.linear_eval task=circor_murmurs pretrain=operaCT dim=768 n_run=5

Reads feature/<task>_eval/ in the working directory; the probe trains on the
card, or on the CPU with `device=cpu`. Best heads land in
cks/linear/<dataset>_<task>/ as state_dict .pt files. The LOOCV regression
tasks and the legacy respiratory tasks are not ported and raise
NotImplementedError.
"""

from __future__ import annotations

import sys

import numpy as np

from ..train.linear_eval import linear_evaluation_heart, linear_evaluation_heart_cv
from .config import resolve

LEGACY_TASKS = {
    "covid19sounds", "icbhidisease", "kauh", "coswarasmoker", "coswarasex",
    "copd", "coughvidcovid", "coughvidsex", "coviduk", "snoring",
}


def route_heart_task(task: str):
    """Task -> (dataset_name, task, feature_dir, labels_filename)
    (linear_eval.py:1895-1937)."""
    if task in ("zchsound_clean", "zchsound_noisy"):
        ds, t = task.split("_")
        return ds, t, f"feature/{task}_eval/", "outcomes.npy"
    if task in ("zchsound_clean_murmurs", "zchsound_noisy_murmurs"):
        a, b, c = task.split("_")
        return f"{a}_{b}", c, f"feature/{a}_{b}_eval/", f"{c}.npy"
    if task in ("pascal_A", "pascal_B"):
        ds, t = task.split("_")
        return ds, t, f"feature/{task}_eval/", "labels.npy"
    if task.startswith("circor_"):
        t = task.split("_", 1)[1]
        return "circor", t, "feature/circor_eval/", f"{t}.npy"
    if task == "physionet16":
        return "physionet16", "", "feature/physionet16_eval/", "labels.npy"
    raise SystemExit(f"unknown heart task: {task}")


def feature_name(cfg) -> str:
    # pretrain=null coerces to None (yaml/hydra); downstream is all string
    # compares ("null" = random-init efficientnet, finetuning.py:183)
    feature = "null" if cfg["pretrain"] is None else cfg["pretrain"]
    if (
        feature not in ["vggish", "opensmile", "clap", "audiomae", "hear", "clap2023"]
        and "audiomae" not in feature
        and "finetuned" not in feature
    ):
        feature += str(cfg["dim"])
    return feature


def main(argv=None):
    """Runs every resolved config; returns one list of test AUROCs for each
    probe run (the best grid point's CV scores for a grid search)."""
    argv = sys.argv[1:] if argv is None else argv
    results = []
    for cfg in resolve("linear_eval_config", argv):
        feature = feature_name(cfg)
        device = cfg.get("device", "cuda")
        if cfg.get("LOOCV"):
            raise NotImplementedError("the LOOCV regression tasks are not ported")
        if cfg["task"] in LEGACY_TASKS:
            raise NotImplementedError(f"legacy task {cfg['task']!r} is not ported")
        ds, task, fdir, labels = route_heart_task(cfg["task"])
        if cfg.get("grid_search"):
            best = (-1, None, None)
            for l2 in cfg["l2_strength_grid"]:
                for lr in cfg["lr_grid"]:
                    scores = []
                    for seed in range(cfg["n_run"]):
                        scores.extend(
                            linear_evaluation_heart_cv(
                                seed=seed,
                                use_feature=feature,
                                feature_dir=fdir,
                                labels_filename=labels,
                                l2_strength=l2,
                                lr=lr,
                                loss=cfg["loss"],
                                head=cfg["head"],
                                epochs=64,
                                device=device,
                            )
                        )
                    m = float(np.mean(scores))
                    print(f"l2={l2} lr={lr}: {m:.3f} ± {np.std(scores):.3f}")
                    if m > best[0]:
                        best = (m, {"l2_strength": l2, "lr": lr}, scores)
            print("=" * 48)
            print(f"Best AUC: {best[0]:.3f} with params: {best[1]}")
            results.append(best[2])
            continue
        scores = []
        for seed in range(cfg["n_run"]):
            res = linear_evaluation_heart(
                seed=seed,
                use_feature=feature,
                l2_strength=cfg["l2_strength"],
                lr=cfg["lr"],
                loss=cfg["loss"],
                head=cfg["head"],
                epochs=64,
                dataset_name=ds,
                task=task,
                feature_dir=fdir,
                labels_filename=labels,
                save_ckpt_dir=f"cks/linear/{ds}_{task}/",
                device=device,
            )
            print(f"seed {seed}: test_auc {res.test_auc:.4f}")
            scores.append(res.test_auc)
        print("=" * 48)
        print(scores)
        print(
            f"Five times mean task {cfg['task']} feature {feature} results: "
            f"auc mean {np.mean(scores):.3f} ± {np.std(scores):.3f}"
        )
        print("=" * 48)
        results.append(scores)
    return results


if __name__ == "__main__":
    main()
