"""Tracing and profiling hooks — counterpart of
heart_murmur_detection_tpu/utils/profiling.py on torch.profiler.

Usage:
    with trace("extract", out_dir="traces/"):   # a torch.profiler trace
        extractor.extract_files(paths)

    with step_timer() as t: ...                  # wall-clock section timing

trace writes a Chrome trace (out_dir/name/trace.json: host ops and, on a
card, its kernels as device records) that chrome://tracing or Perfetto
opens. torch.profiler on a card can drop device records once a process has
lived some tens of seconds, so trace a short, fresh process where the device
records matter.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(name: str, out_dir: str = "traces", enabled: Optional[bool] = None) -> Iterator[None]:
    """torch.profiler trace context (CPU activities, and CUDA where a card
    is there); enable via arg or HMDT_TRACE=1."""
    if enabled is None:
        enabled = os.environ.get("HMDT_TRACE") == "1"
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(out_dir, name)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
    print(f"[trace] wrote {path} (view with chrome://tracing or Perfetto)")


class step_timer:
    """Accumulating section timer for throughput accounting."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.count += 1
        return False

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


def annotate(name: str):
    """A named range in a trace (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)
