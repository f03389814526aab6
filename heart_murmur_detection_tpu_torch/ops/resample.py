"""On-device polyphase resampling (scipy.signal.resample_poly parity) —
counterpart of heart_murmur_detection_tpu/ops/resample.py (`_poly_filter`
:33, `resampled_length` :43, `resampled_lengths` :50,
`resample_poly_device` :57).

The extractor ships audio at its source rate (CirCor 4 kHz) and upsamples
on the device, which cuts host bytes by 16000 / source_sr. The FIR taps are
scipy's (firwin, Kaiser window, cutoff 1/max_rate, half length
10 * max_rate, gain up), so the output matches the host resampler to
float32 round-off.

The JAX version is one zero-stuffed convolution at Precision.HIGHEST. Here
it is a polyphase matrix product instead of a convolution: a float32
convolution on a card goes through cuDNN in TF32 by default
(torch.backends.cudnn.allow_tf32), which would put the resampler near 1e-3,
while a float32 matmul keeps TF32 off by PyTorch's default
(torch.backends.cuda.matmul.allow_tf32 is False). Outputs come in blocks of
`up` samples; block m reads the input window x[m*down + s_lo :
m*down + s_lo + L] (one strided view), and the (L, up) matrix H holds each
output phase's taps, so y = windows @ H. Plain torch: no kernel of the TPU
package runs here (the JAX version is XLA code outside any Pallas kernel).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _poly_filter(up: int, down: int, beta: float = 5.0) -> Tuple[np.ndarray, int]:
    """scipy.signal.resample_poly's FIR: (taps float32, half_len)."""
    from scipy.signal import firwin

    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", beta)) * up
    return h.astype(np.float32), half_len


def resampled_length(n: int, up: int, down: int = 1) -> int:
    """Output length of resample_poly for an n-sample input (ceil(n*up/down))."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    return (n * up + down - 1) // down


def resampled_lengths(lengths: torch.Tensor, up: int, down: int = 1) -> torch.Tensor:
    """resampled_length for a (B,) integer tensor."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    return ((lengths * up + down - 1) // down).to(lengths.dtype)


@functools.lru_cache(maxsize=None)
def _polyphase(up: int, down: int, beta: float) -> Tuple[np.ndarray, int]:
    """(H (L, up) float32, s_lo): output j = m*up + r of resample_poly is
    sum_s x[m*down + s_lo + s] * H[s, r], x zero outside its length.

    scipy pads the filter in front so outputs sit at the centre and drops
    the transient head: y[j] = full[(n_pre_remove + j) * down] with
    full[i] = sum_p x[p] h2[i - p*up]."""
    h, half_len = _poly_filter(up, down, beta)
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    h2 = np.concatenate([np.zeros(n_pre_pad, np.float32), h])
    K = len(h2)
    i0 = n_pre_remove * down
    s_lo = -((K - 1 - i0) // up)  # ceil((i0 - K + 1) / up)
    s_hi = (i0 + (up - 1) * down) // up
    H = np.zeros((s_hi - s_lo + 1, up), np.float32)
    for r in range(up):
        for s in range(s_lo, s_hi + 1):
            k = i0 + r * down - s * up
            if 0 <= k < K:
                H[s - s_lo, r] = h2[k]
    return H, s_lo


@functools.lru_cache(maxsize=None)
def _device_polyphase(device: torch.device, up: int, down: int, beta: float) -> torch.Tensor:
    """_polyphase's H on `device`, copied there once: a pageable host-to-
    device copy on every call would stall the host each batch."""
    H, _ = _polyphase(up, down, beta)
    with torch.inference_mode(False):  # a plain tensor, usable in and out of inference mode
        return torch.from_numpy(H).to(device)


def resample_poly_device(
    x: torch.Tensor, up: int, down: int = 1, beta: float = 5.0
) -> torch.Tensor:
    """Batched resample_poly on x's device: (B, T) float -> (B,
    ceil(T*up/down)) float32.

    Matches scipy.signal.resample_poly(x, up, down, padtype='constant')
    sample for sample (float32 round-off). Rows are resampled over their
    full padded length; zero padding stays zero (the FIR is linear), so a
    row's valid length scales by up/down (resampled_lengths)."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return x
    B, T = x.shape
    n_out = resampled_length(T, up, down)
    _, s_lo = _polyphase(up, down, beta)
    Hd = _device_polyphase(x.device, up, down, float(beta))
    L = Hd.shape[0]
    M = -(-n_out // up)  # output blocks
    # x_ext[q] = x[q + s_lo]: left pad -s_lo zeros, right pad to the last window
    left = max(0, -s_lo)
    start = s_lo + left
    need = start + (M - 1) * down + L
    xf = x.to(torch.float32)
    xe = torch.nn.functional.pad(xf, (left, max(0, need - left - T)))[:, max(0, start):]
    windows = xe.unfold(1, L, down)[:, :M]  # (B, M, L)
    return torch.matmul(windows, Hd).reshape(B, M * up)[:, :n_out]
