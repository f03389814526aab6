"""Pad / split policies for raw waveforms (host-side, numpy).

A copy of heart_murmur_detection_tpu/audio/pad.py trimmed to what the port
runs (split_pad_sample and its helpers for operaCT and operaGT,
split_sample_simple for audiomae, decide_droplast for the fine-tuning
cache); the original cannot be imported without
jax. tests/test_torch_dsp.py and tests/test_torch_mae.py pin it to the
original.

Replicates src/util.py:504-620 exactly:
- 'zero' : equal slices, each zero-padded (or tiled forward when frac < 0.5)
- 'repeat': 50%-hop windows of exactly desired_length; remainder padded with a
  repeat of the whole clip. The reference draws random.random() under a fixed
  seed 7456 (src/util.py:564) which always yields 0.0618 < 0.5, so the source
  is deterministically placed at the END and the front is filled with the tail
  of the repeated signal. We hard-code that branch.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np


def _zero_padding(source: np.ndarray, output_length: int) -> np.ndarray:
    out = np.zeros(output_length, dtype=np.float32)
    n = len(source)
    if n == 0:
        return out
    if n / output_length < 0.5:
        cursor = 0
        while cursor + n < output_length:
            out[cursor : cursor + n] = source
            cursor += n
    else:
        out[:n] = source
    return out


def _equally_slice_pad(x: np.ndarray, desired_sec: float, sr: int) -> List[np.ndarray]:
    output_length = int(desired_sec * sr)
    n = len(x)
    total_sec = n / sr
    n_slices = int(math.ceil(total_sec / desired_sec))
    per_slice = n // n_slices
    out, start = [], 0
    for _ in range(n_slices):
        end = min(start + per_slice, n)
        out.append(_zero_padding(x[start:end], output_length))
        start += end - start
    return out


def _duplicate_padding(clip: np.ndarray, source: np.ndarray, output_length: int) -> np.ndarray:
    out = np.zeros(output_length, dtype=np.float32)
    left = output_length - len(source)
    aug = clip
    while len(aug) < left:
        aug = np.concatenate([aug, aug])
    # seeded draw is < 0.5 in the reference -> always this branch
    out[left:] = source
    if left > 0:
        out[:left] = aug[len(aug) - left :]
    return out


def split_pad_sample(
    x: np.ndarray, desired_sec: float, sr: int, types: str = "repeat"
) -> List[np.ndarray]:
    """Split into desired_sec windows (50% hop); pad the remainder.

    Mirrors split_pad_sample (src/util.py:578-620) but takes/returns bare
    arrays (the reference threads (sample, label, label) tuples through).
    """
    if types == "zero":
        return _equally_slice_pad(x, desired_sec, sr)

    output_length = int(desired_sec * sr)
    n = len(x)
    out: List[np.ndarray] = []
    if n > output_length:
        hop = output_length // 2
        n_frames = 1 + (n - output_length) // hop
        for i in range(n_frames):
            out.append(np.asarray(x[i * hop : i * hop + output_length], dtype=np.float32))
        last = x[n_frames * hop :]
        out.append(_duplicate_padding(x, last, output_length))
    else:
        out.append(_duplicate_padding(x, x, output_length))
    return out


def decide_droplast(n_samples: int, sr: int, input_sec: float) -> bool:
    """src/util.py:369-371: drop the tail window when the remainder is < half."""
    duration = n_samples / sr
    return duration > input_sec and (duration % input_sec) * 2 < input_sec


def split_sample_simple(x: np.ndarray, desired_sec: float, sr: int) -> List[np.ndarray]:
    """Non-overlapping fixed windows incl. short tail (extract_feature.py:250-259)."""
    output_length = int(desired_sec * sr)
    n_frames = int(np.ceil(len(x) / output_length))
    return [x[output_length * i : output_length * (i + 1)] for i in range(n_frames)]
