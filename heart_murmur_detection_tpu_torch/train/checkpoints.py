"""Checkpoint save/restore with reference-compatible naming — counterpart of
heart_murmur_detection_tpu/train/checkpoints.py (`load_params` :28,
`find_best_ckpt` :33, `EarlyStopping` :51, `ResumeCheckpointer` :78,
`TopKCheckpointer` :111).

The cadence and file names are the JAX package's, with the reference's
`.ckpt` suffix: the payloads are torch pickles holding the model's
state_dict under the reference key names ({"state_dict": ...}), so
extract/convert.py::load_torch_ckpt loads a continued-pretraining
checkpoint into the extractor. Files are written to a temporary name and
renamed, so a reader never sees half a checkpoint.
"""

from __future__ import annotations

import glob
import os
import re
import tempfile
from typing import Any, List, Optional, Tuple

import torch


def save_state(path: str, payload: Any) -> str:
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=d)
    os.close(fd)
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return path


def save_params(path: str, state_dict: dict) -> str:
    """A probe head's state_dict, on the CPU, to `path` (the JAX save_params
    :21 with torch.save in place of msgpack)."""
    return save_state(path, _cpu(state_dict))


def load_state(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=False)


def load_params(path: str) -> Any:
    """What save_params wrote (the JAX load_params with torch.load)."""
    return load_state(path)


def find_best_ckpt(
    dirpath: str, pattern: str, metric: str = "valid_auc", mode: str = "max"
) -> Optional[str]:
    """Glob `pattern` under dirpath and pick the best by the metric encoded in
    the filename (eval_ckpts.py:79-88 behavior)."""
    cands = glob.glob(os.path.join(dirpath, pattern))
    best, best_v = None, None
    rx = re.compile(rf"{metric}=([-0-9.]+)")
    for c in cands:
        m = rx.search(os.path.basename(c))
        if not m:
            continue
        v = float(m.group(1).rstrip("."))
        if best_v is None or (v > best_v if mode == "max" else v < best_v):
            best, best_v = c, v
    return best


class EarlyStopping:
    """PL EarlyStopping semantics (reference finetuning.py:1316-1318,
    linear_eval.py:1151-1152): the tracked best moves — and the wait counter
    resets — only on an improvement strictly exceeding min_delta; step()
    returns True once `patience` consecutive non-improvements accumulate.
    patience=None disables stopping (step() always returns False)."""

    def __init__(self, mode: str = "max", min_delta: float = 1e-3,
                 patience: Optional[int] = 10):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.sign = 1.0 if mode == "max" else -1.0
        self.min_delta = float(min_delta)
        self.patience = patience
        self.best = -float("inf")
        self.wait = 0

    def step(self, value: float) -> bool:
        if self.patience is None:
            return False
        v = self.sign * float(value)
        if v - self.min_delta > self.best:
            self.best, self.wait = v, 0
            return False
        self.wait += 1
        return self.wait >= self.patience


def _cpu(state_dict: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in state_dict.items()}


class ResumeCheckpointer:
    """Full-train-state 'last' checkpoint for automatic resume: saves
    {epoch, state_dict, optimizer, extra} every N epochs to <dir>/last.ckpt."""

    def __init__(self, dirpath: str, every_n_epochs: int = 5):
        self.path = os.path.join(dirpath, "last.ckpt")
        self.every = every_n_epochs

    def save(self, epoch: int, state_dict: dict, opt_state: dict,
             extra: Optional[dict] = None) -> None:
        if (epoch + 1) % self.every != 0:
            return
        save_state(self.path, {"epoch": epoch, "state_dict": _cpu(state_dict),
                               "optimizer": opt_state, "extra": extra or {}})

    def restore(self) -> Optional[Tuple[int, dict, dict, dict]]:
        """(epoch, state_dict, optimizer state, extra) or None."""
        if not os.path.exists(self.path):
            return None
        p = load_state(self.path)
        return int(p["epoch"]), p["state_dict"], p["optimizer"], p.get("extra", {})


class TopKCheckpointer:
    """save_top_k behavior of pl.ModelCheckpoint (cola_training.py:266-273):
    keep the k best checkpoints by a monitored metric, save every N epochs.

    step() applies its own every_n_epochs gate on top of the caller's: the
    CP loop calls it only on eval epochs, so checkpoints land on epochs
    divisible by both cadences."""

    def __init__(
        self,
        dirpath: str,
        filename_fmt: str,
        monitor: str = "valid_loss",
        mode: str = "min",
        save_top_k: int = 5,
        every_n_epochs: int = 1,
    ):
        self.dirpath = dirpath
        self.fmt = filename_fmt
        self.monitor = monitor
        self.mode = mode
        self.k = save_top_k
        self.every = every_n_epochs
        self.kept: List[Tuple[float, str]] = []

    def step(self, epoch: int, metric_value: float, state_dict: dict, **fmt_kw) -> Optional[str]:
        if self.every and (epoch + 1) % self.every != 0:
            return None
        sign = -1.0 if self.mode == "min" else 1.0
        score = sign * float(metric_value)
        if len(self.kept) >= self.k and score <= min(s for s, _ in self.kept):
            return None
        name = self.fmt.format(epoch=epoch, **{self.monitor: metric_value}, **fmt_kw)
        path = save_state(os.path.join(self.dirpath, name), {"state_dict": _cpu(state_dict)})
        self.kept.append((score, path))
        self.kept.sort(key=lambda t: -t[0])
        while len(self.kept) > self.k:
            _, worst = self.kept.pop()
            try:
                os.remove(worst)
            except OSError:
                pass
        return path

    @property
    def best_path(self) -> Optional[str]:
        return self.kept[0][1] if self.kept else None
