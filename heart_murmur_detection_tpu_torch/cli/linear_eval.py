"""Linear-probe evaluation CLI — counterpart of
heart_murmur_detection_tpu/cli/linear_eval.py (`route_heart_task` :21,
`feature_name` :41, `run_legacy` :60, `main` :104): the heart tasks and
their grid search, the legacy OPERA respiratory tasks (LEGACY_TASKS, 5
seeds of train/legacy_tasks.py's task functions) and the two LOOCV regression
tasks (LOOCV=True task=spirometry | rr).

Usage:
  python -m heart_murmur_detection_tpu_torch.cli.linear_eval task=circor_murmurs pretrain=operaCT dim=768 n_run=5
  python -m heart_murmur_detection_tpu_torch.cli.linear_eval task=circor_murmurs   # operaCE1280
  python -m heart_murmur_detection_tpu_torch.cli.linear_eval task=circor_murmurs pretrain=null-efficientnet
  python -m heart_murmur_detection_tpu_torch.cli.linear_eval task=copd pretrain=operaCT dim=768
  python -m heart_murmur_detection_tpu_torch.cli.linear_eval LOOCV=True task=spirometry label=FVC modality=breath pretrain=operaCT dim=768
  python -m heart_murmur_detection_tpu_torch.cli.linear_eval LOOCV=True task=rr head=mlp pretrain=operaGT dim=384

Reads feature/<task>_eval/ in the working directory; the probe trains on the
card, or on the CPU with `device=cpu`. Best heads of the heart tasks land in
cks/linear/<dataset>_<task>/ as state_dict .pt files.
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


def run_legacy(cfg, feature, seed, device="cuda"):
    """Task routing for the legacy OPERA tasks (linear_eval.py:1798-1893):
    one seed's test AUROC."""
    from ..train import legacy_tasks as lt

    t = cfg["task"]
    if t == "covid19sounds":
        return lt.linear_evaluation_covid19sounds(
            1, feature, modality=cfg["modality"], l2_strength=cfg["l2_strength"],
            lr=cfg["lr"], head=cfg["head"], seed=seed, device=device)
    if t == "icbhidisease":
        return lt.linear_evaluation_icbhidisease(
            use_feature=feature, epochs=64, batch_size=32,
            l2_strength=cfg["l2_strength"], lr=cfg["lr"], head=cfg["head"], seed=seed,
            device=device)
    if t == "kauh":
        return lt.linear_evaluation_kauh(
            use_feature=feature, epochs=50, batch_size=32,
            l2_strength=cfg["l2_strength"], lr=cfg["lr"], head=cfg["head"], seed=seed,
            device=device)
    if t in ("coswarasmoker", "coswarasex"):
        return lt.linear_evaluation_coswara(
            use_feature=feature, epochs=64, l2_strength=cfg["l2_strength"],
            batch_size=32, lr=cfg["lr"], modality=cfg["modality"],
            label=t.removeprefix("coswara"), head=cfg["head"], seed=seed, device=device)
    if t == "copd":
        return lt.linear_evaluation_copd(
            use_feature=feature, l2_strength=cfg["l2_strength"], lr=cfg["lr"],
            head=cfg["head"], epochs=64, seed=seed, device=device)
    if t in ("coughvidcovid", "coughvidsex"):
        return lt.linear_evaluation_coughvid(
            use_feature=feature, epochs=64, l2_strength=cfg["l2_strength"],
            lr=cfg["lr"], batch_size=64,
            label="covid" if t.endswith("covid") else "gender",
            head=cfg["head"], seed=seed, device=device)
    if t == "coviduk":
        return lt.linear_evaluation_coviduk(
            use_feature=feature, epochs=64, l2_strength=cfg["l2_strength"],
            lr=cfg["lr"], batch_size=64, modality=cfg["modality"],
            head=cfg["head"], seed=seed, device=device)
    if t == "snoring":
        return lt.linear_evaluation_ssbpr(
            use_feature=feature, l2_strength=cfg["l2_strength"], lr=cfg["lr"],
            head=cfg["head"], epochs=32, seed=seed, device=device)
    raise SystemExit(f"unknown legacy task {t}")


def run_loocv(cfg, feature, device="cuda"):
    """The LOOCV regression tasks (linear_eval.py:1039-1346): the lists of
    test MAE and MAPE, a fold each."""
    from ..train import legacy_tasks as lt

    if cfg["task"] == "spirometry":
        return lt.linear_evaluation_mmlung(
            use_feature=feature, l2_strength=1e-1, epochs=64, lr=1e-1,
            batch_size=64, modality=cfg["modality"], label=cfg["label"],
            head=cfg["head"], device=device)
    if cfg["task"] == "rr":
        return lt.linear_evaluation_nosemic(
            use_feature=feature, l2_strength=1e-1, epochs=64,
            batch_size=64, lr=1e-4, head=cfg["head"], device=device)
    raise SystemExit(f"unknown LOOCV task {cfg['task']}")


def main(argv=None):
    """Runs every resolved config; returns one result for each: the list of
    test AUROCs of a probe run (the best grid point's CV scores for a grid
    search), or the (MAEs, MAPEs) lists of a LOOCV run."""
    argv = sys.argv[1:] if argv is None else argv
    results = []
    for cfg in resolve("linear_eval_config", argv):
        feature = feature_name(cfg)
        device = cfg.get("device", "cuda")
        if cfg.get("LOOCV"):
            maes, mapes = run_loocv(cfg, feature, device)
            print(f"MAE mean {np.mean(maes):.3f} ± {np.std(maes):.3f}")
            print(f"MAPE mean {np.mean(mapes):.3f} ± {np.std(mapes):.3f}")
            results.append((maes, mapes))
            continue
        if cfg["task"] in LEGACY_TASKS:
            scores = [run_legacy(cfg, feature, seed, device) for seed in range(cfg["n_run"])]
            print("=" * 48)
            print(scores)
            print(
                f"Five times mean task {cfg['task']} feature {feature} results: "
                f"auc mean {np.mean(scores):.3f} ± {np.std(scores):.3f}"
            )
            results.append(scores)
            continue
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
