"""Training-log curve plotting from CSV logs (res_analysis/show_logs.py) —
a copy of heart_murmur_detection_tpu/analysis/logs.py (matplotlib is
imported inside plot_log: the card's machine has none)."""

from __future__ import annotations

import csv
import os
from typing import Optional, Sequence


def read_csv_log(path: str) -> dict:
    cols: dict = {}
    with open(path) as f:
        for row in csv.DictReader(f):
            for k, v in row.items():
                try:
                    cols.setdefault(k, []).append(float(v))
                except (TypeError, ValueError):
                    pass
    return cols


def plot_log(
    path: str,
    metrics: Sequence[str] = ("train_loss", "valid_loss"),
    out_path: Optional[str] = None,
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cols = read_csv_log(path)
    fig, ax = plt.subplots(figsize=(8, 5))
    for m in metrics:
        if m in cols:
            ax.plot(cols[m], label=m)
    ax.set_xlabel("epoch")
    ax.legend()
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, bbox_inches="tight", dpi=120)
        plt.close(fig)
    return fig
