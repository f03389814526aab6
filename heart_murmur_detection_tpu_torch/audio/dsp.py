"""Batched device DSP in torch (counterpart of heart_murmur_detection_tpu/audio/dsp.py).

    wav (B, Nmax) zero-padded + lengths (B,)  ->  mel (B, Tmax, n_mels) + frames (B,)
                                              ->  kaldi fbank (B, Tmax, 128) + frames (B,)
                                              ->  44.1 kHz CLAP log-mel (B, Tmax, 64) + frames (B,)

The same math as the JAX frontends: the windowed DFT is two real matrix
products against precomputed cos/sin bases (the split-DFT form for the mel,
block framing for the fbank; no `torch.stft`), the bicubic time resize is a
banded weight matrix contracted against x. These are plain products outside
any kernel; on a CUDA card they run as float32 matmuls (PyTorch's default
keeps TF32 off for them).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import reference_np as ref


# ---------------------------------------------------------------------------
# precomputed constant bases (host numpy, cached)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dft_bases(n_fft: int, window: str) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT bases: frames @ cos -> Re, frames @ (-sin) -> Im."""
    k = np.arange(1 + n_fft // 2)
    n = np.arange(n_fft)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    if window == "hann_periodic":
        w = ref.hann_periodic(n_fft)
    elif window == "none":
        w = np.ones(n_fft)
    else:
        raise ValueError(window)
    cos = (np.cos(ang) * w[:, None]).astype(np.float32)
    sin = (-np.sin(ang) * w[:, None]).astype(np.float32)
    return cos, sin


@functools.lru_cache(maxsize=None)
def _mel_fb(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    return ref.mel_filterbank_slaney(sr, n_fft, n_mels, fmin, fmax).T.copy()  # (bins, mels)


@functools.lru_cache(maxsize=None)
def _device_constants(
    device: torch.device, sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cos, sin, mel filterbank) on `device`, copied there once: a pageable
    host-to-device copy on every call would stall the host each batch."""
    cos, sin = _dft_bases(n_fft, "hann_periodic")
    fb = _mel_fb(sr, n_fft, n_mels, fmin, fmax)
    with torch.inference_mode(False):  # plain tensors, usable in and out of inference mode
        return tuple(torch.from_numpy(a).to(device) for a in (cos, sin, fb))


@functools.lru_cache(maxsize=None)
def _kaldi_constants(
    device: torch.device, sr: int, win: int, padded: int, num_mel_bins: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(symmetric Hanning window, cos, sin, kaldi banks (padded//2, mels))
    on `device`, copied there once."""
    cos, sin = _dft_bases(padded, "none")
    w = ref.hanning_symmetric(win).astype(np.float32)
    banks = np.ascontiguousarray(ref.kaldi_mel_banks(num_mel_bins, padded, sr).T)
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a).to(device) for a in (w, cos, sin, banks))


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


def frame_signal(x: torch.Tensor, win: int, hop: int, Tmax: int) -> torch.Tensor:
    """(B, P) -> (B, Tmax, win) overlapping frames, frame t = x[t*hop : t*hop+win].

    Conv-free block framing, as the JAX frame_signal: the signal is reshaped
    into gcd(win, hop)-sample blocks and each frame is win//g consecutive
    blocks starting at a fixed stride (win//g strided slices and one concat).
    Zero-pads x when hop*(Tmax-1)+win exceeds its length; samples past frame
    Tmax-1 are dropped."""
    B, P = x.shape
    g = math.gcd(win, hop)
    step, width = hop // g, win // g
    need = hop * (Tmax - 1) + win
    x = torch.nn.functional.pad(x, (0, need - P)) if P < need else x[:, :need]
    blocks = x.reshape(B, need // g, g)
    parts = [blocks[:, k : k + step * (Tmax - 1) + 1 : step] for k in range(width)]
    return torch.cat(parts, dim=2) if width > 1 else parts[0]


# ---------------------------------------------------------------------------
# mel frontend (librosa parity)
# ---------------------------------------------------------------------------


def log10_mel(
    wav: torch.Tensor,
    sr: int = 16000,
    n_mels: int = 64,
    fmin: float = 50.0,
    fmax: float = 8000.0,
    n_fft: int = 1024,
    hop: int = 512,
) -> torch.Tensor:
    """log10(max(mel power, 1e-10)) of (B, N) float waveforms, N a multiple
    of hop: (B, N//hop + 1, n_mels), in wav's dtype (float32, or float64 for
    a reference of the float32 bases). The plain version of the fused
    log-mel kernel (ops/mel.py)."""
    if hop * 2 != n_fft:
        raise ValueError("the mel frontend assumes 50% hop (reference uses 1024/512)")
    B, Nmax = wav.shape
    if Nmax % hop:
        raise ValueError(f"waveform length {Nmax} is not a multiple of the hop {hop}")
    pad = n_fft // 2
    x = torch.nn.functional.pad(wav, (pad, pad))
    Tmax = Nmax // hop + 1

    # split-DFT framing: frame t = [seg_t, seg_{t+1}] with hop-sized segments,
    # so frames @ cos = segs @ cos_top (shifted-add) segs @ cos_bot; the
    # (B, T, n_fft) double-width frame tensor is never materialised
    cos, sin, fb = (t.to(wav.dtype)  # a copy only for a float64 reference
                    for t in _device_constants(wav.device, sr, n_fft, n_mels, fmin, fmax))
    segs = x.reshape(B, -1, hop)  # (B, S, hop)
    top = torch.matmul(segs, cos[:hop])  # (B, S, bins)
    bot = torch.matmul(segs, cos[hop:])
    re = top[:, :Tmax] + bot[:, 1 : Tmax + 1]
    top = torch.matmul(segs, sin[:hop])
    bot = torch.matmul(segs, sin[hop:])
    im = top[:, :Tmax] + bot[:, 1 : Tmax + 1]
    power = re * re + im * im

    mel = torch.matmul(power, fb)  # (B, Tmax, n_mels)
    return torch.log10(torch.clamp(mel, min=1e-10))


def mel_frontend(
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched pre_process_audio_mel_t (src/util.py:481-501).

    Args:
      wav: (B, Nmax) float32 (or int16 PCM), each row zero-padded beyond its
        length; Nmax a multiple of hop.
      lengths: (B,) int32 valid sample counts.
    Returns:
      mel: (B, Tmax, n_mels) min-max normalised (invalid frames zeroed),
      n_frames: (B,) int32 valid frame counts (= lengths//hop + 1).
    """
    if not torch.is_floating_point(wav):
        wav = wav.to(torch.float32) / 32768.0
    logm = 10.0 * log10_mel(wav, sr, n_mels, fmin, fmax, n_fft, hop)
    return db_normalise(logm, lengths, hop, top_db, normalize)


def db_normalise(
    logm: torch.Tensor, lengths: torch.Tensor, hop: int, top_db: float, normalize: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """10 log10 mel power (B, T, n_mels) -> the frontend's output: dB against
    each clip's max over its valid frames, floored at -top_db, min-max
    normalised over the valid frames, invalid frames zeroed; and the valid
    frame counts lengths // hop + 1 (int32)."""
    n_frames = (lengths.to(torch.int64) // hop + 1).to(torch.int32)
    valid = torch.arange(logm.shape[1], device=logm.device)[None, :] < n_frames[:, None]
    vmask = valid[:, :, None]
    ref_db = torch.where(vmask, logm, -float("inf")).amax(dim=(1, 2), keepdim=True)
    db = logm - ref_db
    db = torch.clamp(db, min=-top_db)  # max over valid is 0, so the top_db floor is -top_db

    if normalize:
        lo = torch.where(vmask, db, float("inf")).amin(dim=(1, 2), keepdim=True)
        hi = torch.where(vmask, db, -float("inf")).amax(dim=(1, 2), keepdim=True)
        scale = torch.where(hi > lo, 1.0 / torch.clamp(hi - lo, min=1e-12), 1.0)
        db = (db - lo) * scale
    out = torch.where(vmask, db, 0.0)
    return out.to(torch.float32), n_frames


def logmel_frontend_general(
    wav: torch.Tensor,
    lengths: torch.Tensor,
    sr: int = 44100,
    n_mels: int = 64,
    fmin: float = 50.0,
    fmax: float = 14000.0,
    n_fft: int = 1024,
    hop: int = 320,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """torchlibrosa-semantics log-mel (Spectrogram center=True with reflect
    padding, LogmelFilterBank ref 1.0, amin 1e-10, top_db None; msclap's
    frontend), as the JAX logmel_frontend_general :200: reflect pad of
    n_fft // 2, Tmax = Nmax // hop + 1 frames at any hop, periodic-Hann DFT
    bases, power, the slaney filterbank, 10 log10(max(mel, 1e-10)).

    wav: (B, Nmax) float32; lengths: (B,) valid sample counts. Returns
    (B, Tmax, n_mels) float32 with frames at or past lengths // hop + 1
    zeroed, and those counts (int32). Plain float32 products (XLA-level
    code in the JAX package: no kernel)."""
    B, Nmax = wav.shape
    pad = n_fft // 2
    x = torch.nn.functional.pad(wav.to(torch.float32)[:, None], (pad, pad), mode="reflect")[:, 0]
    Tmax = Nmax // hop + 1
    frames = frame_signal(x, n_fft, hop, Tmax)
    cos, sin, fb = _device_constants(wav.device, sr, n_fft, n_mels, fmin, fmax)
    re = torch.matmul(frames, cos)
    im = torch.matmul(frames, sin)
    power = re * re + im * im
    mel = torch.matmul(power, fb)
    logmel = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    n_frames = (lengths.to(torch.int64) // hop + 1).to(torch.int32)
    valid = torch.arange(Tmax, device=wav.device)[None, :] < n_frames[:, None]
    return torch.where(valid[:, :, None], logmel, 0.0), n_frames


# ---------------------------------------------------------------------------
# kaldi fbank frontend (Audio-MAE)
# ---------------------------------------------------------------------------


def kaldi_fbank_frontend(
    wav: torch.Tensor,
    lengths: torch.Tensor,
    sr: int = 16000,
    num_mel_bins: int = 128,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    preemphasis: float = 0.97,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched kaldi fbank (src/util.py:841-856 semantics, dither 0), as the
    JAX kaldi_fbank_frontend with its defaults: int16 PCM is scaled by
    1/32768, the valid-region mean is subtracted, then per frame DC removal,
    pre-emphasis, the symmetric Hanning window, zero-padding to a power of
    two, power spectrum, kaldi mel banks and log(max(., float32 eps)).

    Returns (B, Tmax, num_mel_bins) with invalid frames zeroed, and (B,)
    int32 valid frame counts (1 + (len - win) // shift, 0 if len < win).
    """
    dev = wav.device
    if not torch.is_floating_point(wav):
        wav = wav.to(torch.float32) / 32768.0
    B, Nmax = wav.shape
    win = int(sr * frame_length_ms / 1000)
    shift = int(sr * frame_shift_ms / 1000)
    padded = 1 << (win - 1).bit_length()
    w, cos, sin, banks = _kaldi_constants(dev, sr, win, padded, num_mel_bins)
    lengths = lengths.to(torch.int64)

    # the reference subtracts the valid-region mean before the fbank
    mean = wav.sum(1, keepdim=True) / torch.clamp(lengths[:, None], min=1)
    valid_n = torch.arange(Nmax, device=dev)[None, :] < lengths[:, None]
    wav = torch.where(valid_n, wav - mean, 0.0)

    Tmax = max(1 + (Nmax - win) // shift, 1)
    frames = frame_signal(wav, win, shift, Tmax).to(torch.float32)
    frames = frames - frames.mean(-1, keepdim=True)
    prev = torch.cat([frames[:, :, :1], frames[:, :, :-1]], dim=-1)
    frames = (frames - preemphasis * prev) * w

    fr = torch.nn.functional.pad(frames, (0, padded - win))
    re = torch.matmul(fr, cos)
    im = torch.matmul(fr, sin)
    power = re * re + im * im  # (B, T, padded//2 + 1)
    mel_e = torch.matmul(power[:, :, : padded // 2], banks)
    mel_e = torch.log(torch.clamp(mel_e, min=float(np.finfo(np.float32).eps)))

    n_frames = torch.where(
        lengths >= win, 1 + (lengths - win) // shift, torch.zeros_like(lengths)
    ).to(torch.int32)
    valid = torch.arange(Tmax, device=dev)[None, :] < n_frames[:, None]
    return torch.where(valid[:, :, None], mel_e, 0.0), n_frames


# ---------------------------------------------------------------------------
# bicubic time-resize with dynamic source length (HTS-AT reshape_wav2img)
# ---------------------------------------------------------------------------


def _cubic_weight(d: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    """Cubic convolution kernel (torch bicubic uses A=-0.75)."""
    d = d.abs()
    w1 = (a + 2.0) * d**3 - (a + 3.0) * d**2 + 1.0
    w2 = a * d**3 - 5.0 * a * d**2 + 8.0 * a * d - 4.0 * a
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    return torch.where(d <= 1.0, w1, torch.where(d < 2.0, w2, zero))


def resize_bicubic_time(
    x: torch.Tensor,
    src_len: torch.Tensor,
    out_len: int,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Bicubic align_corners=True resize along axis 1, per-example source length.

    x: (B, Tmax, F) with rows >= src_len zero. src_len: (B,) int32. Equals
    F.interpolate(mode='bicubic', align_corners=True) on the first src_len
    rows (htsat.py:838-839), batched with dynamic lengths. The banded cubic
    weight matrix W (B, out, Tmax) is built elementwise and contracted
    against x; border replication of the clipped taps is two analytic edge
    corrections (the k=-1 tap folds into s=0 when floor(pos)==0, the k=+2
    tap into s=src-1 when floor(pos)==src-2).

    compute_dtype=torch.bfloat16: bf16 weights and x, float32 accumulation,
    bf16 result (the bf16 extraction flow).
    """
    B, Tmax, F = x.shape
    dev = x.device
    srcf = src_len.to(torch.float32)  # (B,)
    j = torch.arange(out_len, dtype=torch.float32, device=dev)[None, :]  # (1, out)
    scale = (srcf - 1.0) / (out_len - 1.0)  # (B,)
    pos = j * scale[:, None]  # (B, out)
    s = torch.arange(Tmax, dtype=torch.float32, device=dev)[None, None, :]  # (1, 1, S)
    w = _cubic_weight(pos[:, :, None] - s)  # (B, out, S), zero for |d|>=2
    w = torch.where(s < srcf[:, None, None], w, 0.0)
    i0 = torch.floor(pos)  # (B, out)
    corr_low = torch.where(i0 == 0.0, _cubic_weight(pos + 1.0), 0.0)
    w = w + (s == 0.0) * corr_low[:, :, None]
    corr_high = torch.where(
        i0 == srcf[:, None] - 2.0, _cubic_weight(pos - srcf[:, None]), 0.0
    )
    w = w + (s == srcf[:, None, None] - 1.0) * corr_high[:, :, None]
    if compute_dtype is not None and compute_dtype != torch.float32:
        # bf16-valued operands in a float32 product == bf16 MMA with f32
        # accumulation, then one rounding of the result
        wq = w.to(compute_dtype).to(torch.float32)
        xq = x.to(compute_dtype).to(torch.float32)
        return torch.bmm(wq, xq).to(compute_dtype)
    return torch.bmm(w, x.to(torch.float32))


# ---------------------------------------------------------------------------
# host-side batch packing
# ---------------------------------------------------------------------------


def pad_batch(
    clips,
    pad_to_multiple: int = 512,
    max_len: Optional[int] = None,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad a list of 1-D clips to a common length (multiple of hop).

    dtype=np.int16 packs float clips as PCM16 (mel_frontend converts on
    device). A numpy copy of the JAX package's pad_batch."""
    lengths = np.array([len(c) for c in clips], dtype=np.int32)
    n = int(lengths.max()) if max_len is None else max_len
    n = ((n + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple
    out = np.zeros((len(clips), n), dtype=dtype)
    for i, c in enumerate(clips):
        m = min(len(c), n)
        if dtype == np.int16 and c.dtype != np.int16:
            out[i, :m] = np.clip(np.round(c[:m] * 32768.0), -32768, 32767)
        else:
            out[i, :m] = c[:m]
        lengths[i] = m
    return out, lengths
