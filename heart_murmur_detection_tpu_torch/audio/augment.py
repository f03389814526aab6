"""Host-side (numpy) COLA augmentations — a copy of the numpy half of
heart_murmur_detection_tpu/audio/augment.py (:113-131), which the JAX
package's device half keeps company with; tests/test_torch_pretrain.py pins
the copy to the original.

Reference semantics (distribution-matched):
- random_crop     src/util.py:30-32   start ~ U{0..T-crop}, contiguous window
- random_mask     src/util.py:35-46   markov row-masking to the clip mean:
                  P(mask row | prev not masked) = rate_start,
                  P(mask row | prev masked) = rate_start + (1-rate_start)*rate_seq
- random_multiply src/util.py:49-51   global gain ~ U(0.9, 1.1)
"""

from __future__ import annotations

import numpy as np


def np_random_crop(rng: np.random.Generator, x: np.ndarray, crop_size: int):
    start = int(rng.random() * (x.shape[0] - crop_size))
    return x[start : start + crop_size]


def np_random_mask(rng, x, rate_start=0.1, rate_seq=0.2):
    out = x.copy()
    mean = out.mean()
    prev = False
    for i in range(out.shape[0]):
        if rng.random() < rate_start or (prev and rng.random() < rate_seq):
            prev = True
            out[i, :] = mean
        else:
            prev = False
    return out


def np_random_multiply(rng, x):
    return x * (0.9 + rng.random() / 5.0)
