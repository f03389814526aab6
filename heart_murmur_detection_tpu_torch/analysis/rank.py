"""Mean-reciprocal-rank over the OPERA 19-task results matrix
(res_analysis/calculate_rank.py) — a copy of
heart_murmur_detection_tpu/analysis/rank.py. Rows 1-12 AUROC (higher better), rows 13-19
MAE (lower better). The published matrix ships as data (BASELINE.md §1)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy.stats import rankdata

METHODS = [
    "Opensmile",
    "VGGish",
    "AudioMAE",
    "CLAP",
    "OPERA-CT",
    "OPERA-CE",
    "OPERA-GT",
]

# mean values of the published table (BASELINE.md §1 / OPERA paper Tables 4-5)
OPERA_RESULTS = np.array([
    [0.550, 0.580, 0.549, 0.565, 0.586, 0.551, 0.605],
    [0.649, 0.557, 0.616, 0.648, 0.701, 0.629, 0.677],
    [0.571, 0.571, 0.583, 0.611, 0.603, 0.610, 0.613],
    [0.633, 0.605, 0.659, 0.669, 0.680, 0.665, 0.673],
    [0.537, 0.538, 0.554, 0.599, 0.578, 0.566, 0.552],
    [0.677, 0.600, 0.628, 0.665, 0.795, 0.721, 0.735],
    [0.579, 0.605, 0.886, 0.933, 0.855, 0.872, 0.741],
    [0.534, 0.507, 0.549, 0.680, 0.685, 0.674, 0.650],
    [0.753, 0.606, 0.724, 0.742, 0.874, 0.801, 0.825],
    [0.636, 0.605, 0.616, 0.697, 0.722, 0.741, 0.703],
    [0.494, 0.590, 0.510, 0.635, 0.625, 0.683, 0.615],
    [0.772, 0.657, 0.649, 0.702, 0.781, 0.769, 0.742],
    [0.985, 0.904, 0.900, 0.896, 0.924, 0.848, 0.892],
    [0.756, 0.839, 0.821, 0.840, 0.837, 0.834, 0.825],
    [0.141, 0.131, 0.129, 0.134, 0.128, 0.132, 0.128],
    [0.850, 0.895, 0.833, 0.883, 0.885, 0.761, 0.878],
    [0.730, 0.842, 0.876, 0.859, 0.780, 0.830, 0.774],
    [0.138, 0.130, 0.131, 0.137, 0.132, 0.136, 0.130],
    [2.714, 2.605, 2.641, 2.650, 2.636, 2.525, 2.416],
])

N_AUROC_ROWS = 12


def task_ranks(matrix: np.ndarray = OPERA_RESULTS, n_auroc: int = N_AUROC_ROWS):
    """Per-task method ranks: rank 1 = best (max AUROC / min MAE)."""
    ranks = np.zeros_like(matrix)
    for i, row in enumerate(matrix):
        if i < n_auroc:
            ranks[i] = rankdata(-row, method="average")
        else:
            ranks[i] = rankdata(row, method="average")
    return ranks


def mean_reciprocal_rank(matrix: np.ndarray = OPERA_RESULTS, n_auroc: int = N_AUROC_ROWS):
    ranks = task_ranks(matrix, n_auroc)
    return (1.0 / ranks).mean(axis=0)


def print_mrr(matrix: np.ndarray = OPERA_RESULTS, methods: Sequence[str] = METHODS):
    mrr = mean_reciprocal_rank(matrix)
    order = np.argsort(-mrr)
    for i in order:
        print(f"{methods[i]:12s} MRR={mrr[i]:.3f}")
    return {methods[i]: float(mrr[i]) for i in range(len(methods))}
