"""Run logging: the CSV logger, the wandb logger and get_run_name of
heart_murmur_detection_tpu/utils/logging.py, copied. CSVLogger (:16) keeps
the cks/logs layout (pl.CSVLogger-like: metrics.csv under
<save_dir>/<name>/<version>, a step_time column, then the metric names in
sorted order, fixed by the first row). WandbLogger (:35) logs to the
reference's projects only when wandb is importable and WANDB_API_KEY or
WANDB_MODE=offline is set; otherwise every call does nothing.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Optional


class CSVLogger:
    """mesh: a data-parallel run's mesh; only its rank 0 writes."""

    def __init__(self, save_dir: str, name: str, version: Optional[str] = None, mesh=None):
        self.dir = os.path.join(save_dir, name, version or "")
        self.path = os.path.join(self.dir, "metrics.csv")
        self.writes = mesh is None or mesh.rank == 0
        if self.writes:
            os.makedirs(self.dir, exist_ok=True)
        self._fields = None

    def log(self, **metrics):
        if not self.writes:
            return
        write_header = self._fields is None and not os.path.exists(self.path)
        if self._fields is None:
            self._fields = ["step_time"] + sorted(metrics.keys())
        row = {"step_time": time.time(), **metrics}
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields, extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow(row)


class WandbLogger:
    """project None: log nothing (a data-parallel run's other ranks)."""

    def __init__(self, project: Optional[str], name: str, config: Optional[dict] = None):
        self._run = None
        if project is not None and (os.environ.get("WANDB_API_KEY")
                                    or os.environ.get("WANDB_MODE") == "offline"):
            try:
                import wandb

                self._run = wandb.init(project=project, name=name, config=config or {})
            except Exception:  # noqa: BLE001 - logging must never stop a run
                self._run = None

    def log(self, metrics: dict):
        if self._run is not None:
            self._run.log(metrics)

    def finish(self):
        if self._run is not None:
            self._run.finish()


def get_run_name(title: str) -> str:
    s = time.gmtime(time.time())
    return f"{time.strftime('%Y-%m-%d %H:%M:%S', s)}-{title}"
