"""Spectrogram augmentations: the host-side (numpy) COLA augmentations — a
copy of the numpy half of heart_murmur_detection_tpu/audio/augment.py
(:113-131), which tests/test_torch_pretrain.py pins to the original — and
the device-side ones in torch: the COLA views (`random_crop` :28,
`random_mask` :37, `random_multiply` :56, `cola_views` :60) and the
SpecAugment of fine-tuning (`spec_augment` :93, `_drop_stripes` :76).

Each device augmentation draws its uniforms from an explicit
torch.Generator and applies them with a deterministic function (crop_at,
mask_at, multiply_at), which the tests hold to the JAX function on the
JAX draws. random_mask's Markov chain over rows is evaluated without a
sequential scan: row t is masked when some row s <= t started a run (u1_s
< rate_start) and every row after s continued it (u2 < rate_seq).

SpecAugment is split in two: spec_augment_draw draws each sample's stripes
(widths and starts) from an explicit torch.Generator, and drop_stripes_at
zeroes given stripes deterministically. Torch's random numbers are not
JAX's (PARITY.md deviation 1), so tests/test_torch_finetune.py holds
drop_stripes_at to the JAX mask on the JAX draws, and the draw to its
ranges.

Reference semantics (distribution-matched):
- random_crop     src/util.py:30-32   start ~ U{0..T-crop}, contiguous window
- random_mask     src/util.py:35-46   markov row-masking to the clip mean:
                  P(mask row | prev not masked) = rate_start,
                  P(mask row | prev masked) = rate_start + (1-rate_start)*rate_seq
- random_multiply src/util.py:49-51   global gain ~ U(0.9, 1.1)
- SpecAugment     torchlibrosa.SpecAugmentation (htsat.py:604-609,
                  finetuning.py:63-69): per stripe, width ~ U{0..drop_width-1},
                  begin ~ U{0..dim-width-1}, zeroed. stripes_num per axis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


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


# ---------------------------------------------------------------------------
# device COLA augmentations (torch), on one (T, F) spectrogram
# ---------------------------------------------------------------------------


def crop_at(x: torch.Tensor, u: torch.Tensor, crop_size: int) -> torch.Tensor:
    """The crop of x (T, F) at start int(u (T - crop_size)), clipped."""
    T = x.shape[0]
    start = torch.clamp((u * (T - crop_size)).to(torch.int64), 0, max(T - crop_size, 0))
    return x[start + torch.arange(crop_size, device=x.device)]


def random_crop(gen: Optional[torch.Generator], x: torch.Tensor, crop_size: int) -> torch.Tensor:
    """Contiguous time crop. x: (T, F) -> (crop_size, F)."""
    return crop_at(x, torch.rand((), generator=gen, device=x.device), crop_size)


def mask_at(x: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor, rate_start: float = 0.1,
            rate_seq: float = 0.2) -> torch.Tensor:
    """Markov row masking of x (T, F) to its mean on the draws u1, u2 (T,):
    z_t = (u1_t < rate_start) | (z_{t-1} & (u2_t < rate_seq))."""
    t = torch.arange(x.shape[0], device=x.device)
    none = torch.full_like(t, -1)
    last_start = torch.cummax(torch.where(u1 < rate_start, t, none), 0).values
    last_break = torch.cummax(torch.where(u2 < rate_seq, none, t), 0).values
    z = (last_start >= 0) & (last_break <= last_start)
    return torch.where(z[:, None], x.mean(), x)


def random_mask(gen: Optional[torch.Generator], x: torch.Tensor, rate_start: float = 0.1,
                rate_seq: float = 0.2) -> torch.Tensor:
    """Markov row masking to the clip mean. x: (T, F)."""
    u = torch.rand(2, x.shape[0], generator=gen, device=x.device)
    return mask_at(x, u[0], u[1], rate_start, rate_seq)


def multiply_at(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return x * (0.9 + u / 5.0)


def random_multiply(gen: Optional[torch.Generator], x: torch.Tensor) -> torch.Tensor:
    """A global gain ~ U(0.9, 1.1)."""
    return multiply_at(x, torch.rand((), generator=gen, device=x.device))


def cola_views(gen: Optional[torch.Generator], x: torch.Tensor, crop_size: int,
               augment: bool = True):
    """The COLA positive-pair pipeline (cola_training.py:63-76): mask -> two
    independent crops -> independent gains. x: (T, F)."""
    if augment:
        x = random_mask(gen, x)
    x1 = random_crop(gen, x, crop_size)
    x2 = random_crop(gen, x, crop_size)
    if augment:
        x1 = random_multiply(gen, x1)
        x2 = random_multiply(gen, x2)
    return x1, x2


# ---------------------------------------------------------------------------
# device SpecAugment (torch)
# ---------------------------------------------------------------------------

Stripes = Tuple[torch.Tensor, torch.Tensor]  # (starts, widths), each (B, stripes) int64


def _draw_stripes(gen: Optional[torch.Generator], B: int, dim: int, drop_width: int, num: int,
                  device) -> Stripes:
    """Each sample's `num` stripes along an axis of length dim: width ~
    U{0..drop_width-1}, start ~ U{0..max(dim - width, 1) - 1} (the JAX
    randint bounds)."""
    if drop_width <= 0 or num <= 0:
        empty = torch.zeros(B, 0, dtype=torch.int64, device=device)
        return empty, empty
    u = torch.rand(2, B, num, generator=gen, device=device, dtype=torch.float64)
    width = (u[0] * drop_width).floor().to(torch.int64)
    hi = torch.clamp(dim - width, min=1)
    start = torch.minimum((u[1] * hi).floor().to(torch.int64), hi - 1)
    return start, width


def spec_augment_draw(
    gen: Optional[torch.Generator],
    B: int,
    T: int,
    F: int,
    time_drop_width: int = 64,
    time_stripes_num: int = 2,
    freq_drop_width: int = 8,
    freq_stripes_num: int = 2,
    device=None,
) -> Tuple[Stripes, Stripes]:
    """The stripes of a (B, T, F) batch: ((time starts, widths), (freq
    starts, widths))."""
    return (_draw_stripes(gen, B, T, time_drop_width, time_stripes_num, device),
            _draw_stripes(gen, B, F, freq_drop_width, freq_stripes_num, device))


def _stripe_mask(stripes: Stripes, dim: int, device) -> torch.Tensor:
    start, width = stripes
    idx = torch.arange(dim, device=device)[None, None]
    hit = (idx >= start[..., None]) & (idx < (start + width)[..., None])
    return hit.any(1)  # (B, dim)


def drop_stripes_at(x: torch.Tensor, time: Stripes, freq: Stripes) -> torch.Tensor:
    """Zero the given stripes of x (B, T, F): rows [start, start + width) of
    each time stripe, columns of each frequency stripe."""
    B, T, F = x.shape
    mask = _stripe_mask(time, T, x.device)[:, :, None] | _stripe_mask(freq, F, x.device)[:, None, :]
    return torch.where(mask, torch.zeros((), dtype=x.dtype, device=x.device), x)


def spec_augment(
    x: torch.Tensor,
    gen: Optional[torch.Generator],
    time_drop_width: int = 64,
    time_stripes_num: int = 2,
    freq_drop_width: int = 8,
    freq_stripes_num: int = 2,
) -> torch.Tensor:
    """SpecAugment stripes on each sample of x (B, T, F), drawn from gen."""
    B, T, F = x.shape
    t, f = spec_augment_draw(gen, B, T, F, time_drop_width, time_stripes_num,
                             freq_drop_width, freq_stripes_num, x.device)
    return drop_stripes_at(x, t, f)
