"""The fused log-mel frontend: one hand-written CUDA kernel (csrc/logmel.cu),
its plain torch version, and the frontend built on it — counterpart of
heart_murmur_detection_tpu/ops/pallas_mel.py (TPU kernel K4, `fused_logmel`
:64, body `_kernel` :54; `mel_frontend_pallas` :119).

  fused_logmel        (B, N) float32 waveforms -> (B, N//512 + 1, 64)
                      log10(max(mel power, 1e-10)): framing with the centre
                      pad, the Hann window, a real FFT a frame, the power
                      and the slaney-mel product over the filterbank's
                      nonzeros, in one launch
  fused_logmel_ref    the plain version of the same function
  mel_frontend_fused  the dB reference, the -80 dB clamp, the per-clip
                      min-max and the frame mask around fused_logmel, in
                      plain torch, as mel_frontend_pallas (:141-153)

Precision: the TPU kernel runs its products at Precision.HIGHEST (strict
float32); the CUDA kernel is float32 throughout (its FFT, the power and the
mel sums on the SIMT units) and the plain version runs float32 matmuls
(TF32 is off for them by PyTorch's default). The plain version is
audio/dsp.py's log10_mel, the body of dsp.mel_frontend; the dB reference,
clamp, min-max and mask are dsp.db_normalise.

The kernel's tables (_device_bases) are built on the host in float64, cast
to float32 and copied to each device once: the periodic Hann window (as
dsp._dft_bases builds it), the twiddles of its 512-point FFT and of the
real-FFT split step (fft_tables), and the filterbank's nonzeros, each mel's
first bin and its weights exactly as dsp._mel_fb holds them (mel_table).

Dispatch: a CPU tensor runs the plain version; a CUDA float32 tensor
launches the kernel; anything else on a card raises. `impl="plain"` asks
mel_frontend_fused for the plain version on any device (the on-card
reference).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..audio import dsp
from ..audio import reference_np as ref
from .swin import _check_launch, _cuda_stream, _ptr

# the kernel's fixed geometry (the reference frontend's: 1024 / 512, 64 mels)
N_FFT, HOP, N_MELS = 1024, 512, 64
KERNEL_BINS = 512  # bins 0..511: the filterbank weights bin 512 by zero (checked)
MEL_NNZ_MAX = 2 * KERNEL_BINS  # a bin feeds at most two triangles


def fft_tables() -> np.ndarray:
    """The kernel's float32 window and twiddles, computed in float64 and cast
    once: [Hann window (1024) | pass-2 twiddles W_64^(r l), r 1..7, l 0..7 |
    pass-3 twiddles W_512^(r j), r 1..7, j 0..63 | split twiddles W_1024^k,
    k 0..511], each twiddle as (re, im) with W_n = exp(-2 pi i / n)."""
    r = np.arange(1, 8)[:, None]
    tw = np.concatenate([
        np.exp(-2j * np.pi * r * np.arange(8)[None] / 64).ravel(),
        np.exp(-2j * np.pi * r * np.arange(64)[None] / 512).ravel(),
        np.exp(-2j * np.pi * np.arange(KERNEL_BINS) / N_FFT),
    ])
    inter = np.stack([tw.real, tw.imag], axis=-1).ravel()
    return np.concatenate([ref.hann_periodic(N_FFT), inter]).astype(np.float32)


def mel_table(sr: int, fmin: float, fmax: float):
    """The filterbank's nonzeros for the kernel: (idx, w) with idx int32
    [first bin of each mel (64) | offsets of its weights in w (65)] and w
    float32, mel m's weights w[off[m]:off[m + 1]] = dsp._mel_fb[first bin:
    first bin + count, m], from its first nonzero bin to its last. Raises
    if the filterbank weights a bin above 511."""
    fb = dsp._mel_fb(sr, N_FFT, N_MELS, fmin, fmax)
    if np.any(fb[KERNEL_BINS:] != 0):
        raise ValueError(
            f"the logmel kernel computes bins 0..{KERNEL_BINS - 1}; the filterbank for "
            f"sr {sr}, fmin {fmin}, fmax {fmax} weights a bin above them"
        )
    first, off, w = [], [0], []
    for m in range(N_MELS):
        nz = np.flatnonzero(fb[:, m])
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        first.append(lo)
        w.append(fb[lo:hi, m])
        off.append(off[-1] + hi - lo)
    if off[-1] > MEL_NNZ_MAX:
        raise ValueError(f"the filterbank has {off[-1]} weights, over {MEL_NNZ_MAX}")
    return np.asarray(first + off, np.int32), np.concatenate(w).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_bases(device: torch.device, sr: int, fmin: float, fmax: float):
    """(fft_tables, mel weights zero-padded to MEL_NNZ_MAX, mel index) on
    `device`, copied there once."""
    idx, w = mel_table(sr, fmin, fmax)
    w = np.pad(w, (0, MEL_NNZ_MAX - w.size))
    with torch.inference_mode(False):  # plain tensors, usable in and out of inference mode
        return tuple(torch.from_numpy(a).to(device) for a in (fft_tables(), w, idx))


# the plain version: frame i = hop-chunk i ++ chunk i+1 of the centre-padded
# signal, the three products in wav's dtype, log10(max(mel, 1e-10))
fused_logmel_ref = dsp.log10_mel


def _check_cuda_args(wav, n_mels, n_fft, hop):
    if wav.dtype != torch.float32:
        raise TypeError(f"the logmel kernel takes float32 waveforms, got {wav.dtype}")
    if wav.dim() != 2 or not wav.is_contiguous() or wav.data_ptr() % 16:
        raise ValueError("wav must be a contiguous, 16-byte aligned (B, N) tensor")
    if (n_fft, hop, n_mels) != (N_FFT, HOP, N_MELS):
        raise ValueError(f"the logmel kernel takes n_fft {N_FFT}, hop {HOP}, {N_MELS} mels; "
                         f"got {n_fft}, {hop}, {n_mels}")
    if wav.shape[1] % HOP or wav.shape[1] == 0 or not 0 < wav.shape[0] <= 65535:
        raise ValueError(f"wav shape {tuple(wav.shape)}: N a positive multiple of {HOP}")


def fused_logmel(
    wav: torch.Tensor,
    sr: int = 16000,
    n_mels: int = 64,
    fmin: float = 50.0,
    fmax: float = 8000.0,
    n_fft: int = 1024,
    hop: int = 512,
) -> torch.Tensor:
    """log10 mel power of (B, N) float32 waveforms -> (B, N//hop + 1,
    n_mels) float32 (see fused_logmel_ref); on a card, one launch of
    csrc/logmel.cu."""
    if wav.device.type == "cpu":
        return fused_logmel_ref(wav, sr, n_mels, fmin, fmax, n_fft, hop)
    _check_cuda_args(wav, n_mels, n_fft, hop)
    B, N = wav.shape
    tables, mel_w, mel_idx = _device_bases(wav.device, sr, float(fmin), float(fmax))
    from . import _build

    lib = _build.load_library()
    out = torch.empty((B, N // HOP + 1, N_MELS), dtype=torch.float32, device=wav.device)
    rc = lib.logmel_launch(_ptr(wav), _ptr(out), _ptr(tables), _ptr(mel_w), _ptr(mel_idx), B,
                           N, _cuda_stream(wav))
    _check_launch("logmel", rc)
    fused_logmel.launches += 1
    return out


fused_logmel.launches = 0


def launch_counts() -> dict:
    """Launches of the logmel kernel since the last reset."""
    return {"logmel": fused_logmel.launches}


def reset_launch_counts() -> None:
    fused_logmel.launches = 0


def mel_frontend_fused(
    wav: torch.Tensor,
    lengths: torch.Tensor,
    sr: int = 16000,
    n_mels: int = 64,
    fmin: float = 50.0,
    fmax: float = 8000.0,
    n_fft: int = 1024,
    hop: int = 512,
    top_db: float = 80.0,
    normalize: bool = True,
    impl: str = "kernel",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for audio/dsp.mel_frontend on the fused kernel: (B, T,
    n_mels) min-max normalised mel (invalid frames zeroed) and (B,) int32
    valid frame counts (lengths // hop + 1). impl="plain" runs the plain
    version on any device (the on-card reference)."""
    if not torch.is_floating_point(wav):
        wav = wav.to(torch.float32) / 32768.0
    logmel = {"kernel": fused_logmel, "plain": fused_logmel_ref}[impl]
    logm10 = logmel(wav.contiguous(), sr, n_mels, fmin, fmax, n_fft, hop)
    return dsp.db_normalise(10.0 * logm10, lengths, hop, top_db, normalize)
