"""The balanced downsampler of the coswara vggish probe — a copy of
heart_murmur_detection_tpu/utils/balance.py (`downsample_balanced_dataset`
:16; the reference's src/util.py:764-791), pinned to the original by
tests/test_torch_legacy.py."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def downsample_balanced_dataset(
    x_train: np.ndarray, y_train: np.ndarray, seed: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Randomly downsample every class to the size of the smallest one. The
    reference draws from the global numpy RNG (seed None); a seed draws from
    np.random.default_rng(seed)."""
    rng = np.random.default_rng(seed) if seed is not None else np.random
    y_train = np.asarray(y_train)
    min_samples = np.bincount(y_train).min()
    xs, ys = [], []
    for c in np.unique(y_train):
        idx = np.where(y_train == c)[0]
        sel = rng.choice(idx, min_samples, replace=False)
        xs.append(np.asarray(x_train)[sel])
        ys.append(y_train[sel])
    return np.concatenate(xs, axis=0), np.concatenate(ys, axis=0)
