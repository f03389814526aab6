"""Determinism helpers — counterpart of
heart_murmur_detection_tpu/utils/seeds.py.

The reference seeds numpy / torch per run (linear_eval.py:1793-1796,
finetuning.py:1373 seed_everything). The port draws its device randomness
from explicit torch.Generators; host shuffles and augmentation use a numpy
Generator derived here.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int) -> torch.Generator:
    """Seed the python, numpy and torch global RNGs and return a
    torch.Generator seeded with `seed` (the JAX function's root key)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def host_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)
