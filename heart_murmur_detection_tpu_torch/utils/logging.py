"""Run logging: the CSV logger of heart_murmur_detection_tpu/utils/logging.py
(:16), copied (cks/logs layout, pl.CSVLogger-like: metrics.csv under
<save_dir>/<name>/<version>, a step_time column, then the metric names in
sorted order, fixed by the first row). The wandb logger is not carried.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Optional


class CSVLogger:
    def __init__(self, save_dir: str, name: str, version: Optional[str] = None):
        self.dir = os.path.join(save_dir, name, version or "")
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "metrics.csv")
        self._fields = None

    def log(self, **metrics):
        write_header = self._fields is None and not os.path.exists(self.path)
        if self._fields is None:
            self._fields = ["step_time"] + sorted(metrics.keys())
        row = {"step_time": time.time(), **metrics}
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields, extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow(row)
