"""Two-model significance test CLI — counterpart of
heart_murmur_detection_tpu/cli/significance.py (`DEFAULTS`, `get_performance`
:36, `main` :63; the reference's src/benchmark/significance_test.py): runs
the 5-seed linear-probe protocol for two models on one heart task and
t-tests their scores.

    python -m heart_murmur_detection_tpu_torch.cli.significance \\
        task=circor_murmurs model1=operaCT dim1=768 model2=clap2023 alpha=0.01

Reads feature/<task>_eval/<feature>_feature.npy in the working directory;
the probes train on the card (`device=cpu` on the CPU). The legacy
respiratory tasks are not ported and raise NotImplementedError.
"""

from __future__ import annotations

import sys

import numpy as np

from ..analysis.significance import test_2models
from ..train.linear_eval import linear_evaluation_heart
from .config import parse_overrides
from .linear_eval import LEGACY_TASKS, route_heart_task

DEFAULTS = dict(
    task="circor_murmurs",
    label="smoker",
    modality="cough",
    model1="operaCT",
    model2="audiomae",
    dim1=768,
    dim2=768,
    alpha=0.01,
    lr=1e-4,
    l2_strength=1e-5,
    head="linear",
    n_run=5,
    loss="weighted",
)


def get_performance(model: str, dim: int, cfg: dict):
    """The n_run seeds' test AUROCs of `model`'s features."""
    feature = model
    if model not in ("vggish", "opensmile", "clap", "audiomae", "hear", "clap2023") and "finetuned" not in model:
        feature += str(dim)
    if cfg["task"] in LEGACY_TASKS:
        raise NotImplementedError(f"legacy task {cfg['task']!r} is not ported")
    ds, task, fdir, labels = route_heart_task(cfg["task"])
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
            device=cfg.get("device", "cuda"),
        )
        scores.append(res.test_auc)
    return scores


def main(argv=None):
    """Returns (scores of model1, scores of model2, (t, p, reject))."""
    argv = sys.argv[1:] if argv is None else argv
    _, combos = parse_overrides(argv)
    cfg = dict(DEFAULTS)
    cfg.update(combos[0] if combos else {})
    s1 = get_performance(cfg["model1"], cfg["dim1"], cfg)
    s2 = get_performance(cfg["model2"], cfg["dim2"], cfg)
    print(f"{cfg['model1']}: {np.mean(s1):.3f} ± {np.std(s1):.3f}  {s1}")
    print(f"{cfg['model2']}: {np.mean(s2):.3f} ± {np.std(s2):.3f}  {s2}")
    return s1, s2, test_2models(s1, s2, alpha=cfg["alpha"])


if __name__ == "__main__":
    main()
