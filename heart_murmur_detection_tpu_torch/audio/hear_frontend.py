"""HeAR's mel-PCEN frontend in torch — counterpart of
heart_murmur_detection_tpu/audio/hear_frontend.py (after hear's
audio_utils.py:365-476): a 2-s clip at 16 kHz -> per-clip min-max to [-1, 1]
-> STFT (frame 400, fft 400, hop 160, periodic hann, pad_end, no centre pad)
-> power -> TF's linear_to_mel_weight_matrix (HTK mel, 128 bins, 0-8000 Hz,
DC bin zeroed) -> PCEN (alpha .8, s .04, delta 2, root 2, floor 1e-8, EMA
seeded with frame 0) -> bilinear resize (half-pixel, align_corners=False)
to (192, 128).

Everything runs in float32 on the waveform's device. The tables (DFT bases,
mel matrix, PCEN's EMA matrix, the resize weights) are built in float64
numpy as the JAX module builds them, cast to float32 once and copied to a
device once. The DFT and mel products run in float32 on every path: the JAX
package's bf16 extraction runs them at Precision.HIGH (bf16x3, about 1e-7
relative), its strict path at HIGHEST.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .dsp import frame_signal

N_SAMPLES = 32000
FRAME = 400
HOP = 160
N_BINS = FRAME // 2 + 1  # 201
OUT_HW = (192, 128)
SCAN_PAST = 2048  # pcen's matmul form falls back to the scan past this many frames


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


@functools.lru_cache(maxsize=None)
def tf_mel_matrix(
    num_mel_bins: int = 128,
    num_spectrogram_bins: int = N_BINS,
    sample_rate: float = 16000.0,
    lower_edge_hertz: float = 0.0,
    upper_edge_hertz: float = 8000.0,
) -> np.ndarray:
    """tf.signal.linear_to_mel_weight_matrix: (bins, mels) float32, the DC
    row zero (a copy of the JAX table)."""
    nyq = sample_rate / 2.0
    freqs = np.linspace(0.0, nyq, num_spectrogram_bins)[1:]  # DC bin excluded
    spec_mel = _hz_to_mel_htk(freqs)
    edges = np.linspace(
        _hz_to_mel_htk(lower_edge_hertz), _hz_to_mel_htk(upper_edge_hertz), num_mel_bins + 2
    )
    lower, center, upper = edges[:-2][None, :], edges[1:-1][None, :], edges[2:][None, :]
    up = (spec_mel[:, None] - lower) / (center - lower)
    down = (upper - spec_mel[:, None]) / (upper - center)
    out = np.zeros((num_spectrogram_bins, num_mel_bins), np.float32)
    out[1:] = np.maximum(0.0, np.minimum(up, down))
    return out


@functools.lru_cache(maxsize=None)
def _dft(frame: int):
    """(frame, frame // 2 + 1) cos and -sin bases with the periodic hann."""
    k = np.arange(frame // 2 + 1)
    n = np.arange(frame)
    ang = 2 * np.pi * np.outer(n, k) / frame
    w = 0.5 - 0.5 * np.cos(2 * np.pi * n / frame)
    return (
        (np.cos(ang) * w[:, None]).astype(np.float32),
        (-np.sin(ang) * w[:, None]).astype(np.float32),
    )


@functools.lru_cache(maxsize=None)
def _ema_matrix(T: int, s: float) -> np.ndarray:
    """The PCEN EMA m_t = (1 - s) m_{t-1} + s e_t, m_0 = e_0, as a lower
    triangular (T, T) matrix: M = A E."""
    t = np.arange(T)[:, None]
    j = np.arange(T)[None, :]
    A = s * (1.0 - s) ** (t - j)
    A[:, 0] = (1.0 - s) ** t[:, 0]
    return np.where(j <= t, A, 0.0).astype(np.float32)


def _axis_weights(n_in: int, n_out: int):
    pos = (np.arange(n_out) + 0.5) * n_in / n_out - 0.5
    i0 = np.clip(np.floor(pos), 0, n_in - 1).astype(np.int64)
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    frac = np.clip(pos - i0, 0.0, 1.0).astype(np.float32)
    return i0, i1, frac


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) 2-tap bilinear weights (half-pixel, TF semantics)."""
    i0, i1, frac = _axis_weights(n_in, n_out)
    W = np.zeros((n_out, n_in), np.float32)
    W[np.arange(n_out), i0] += 1.0 - frac
    W[np.arange(n_out), i1] += frac
    return W


@functools.lru_cache(maxsize=None)
def _on(device: torch.device, name: str, *args) -> torch.Tensor:
    """A table on `device`, copied there once; plain tensors, usable in and
    out of inference mode."""
    tables = {"cos": lambda f: _dft(f)[0], "sin": lambda f: _dft(f)[1], "mel": tf_mel_matrix,
              "ema": _ema_matrix, "resize": _resize_matrix}
    with torch.inference_mode(False):
        return torch.from_numpy(tables[name](*args)).to(device)


def pcen(
    E: torch.Tensor,
    alpha: float = 0.8,
    s: float = 0.04,
    delta: float = 2.0,
    root: float = 2.0,
    floor: float = 1e-8,
    impl: str = "matmul",
) -> torch.Tensor:
    """Per-channel energy normalisation over time axis 1 of E (B, T, F),
    float32. impl "matmul": the EMA as one triangular product (the JAX
    default; the scan past T 2048, where the matrix grows and (1 - s)^t
    underflows); "scan": the literal recurrence."""
    if impl not in ("matmul", "scan"):
        raise ValueError(f"impl must be 'matmul' or 'scan', got {impl!r}")
    T = E.shape[1]
    if impl == "matmul" and T <= SCAN_PAST:
        M = _on(E.device, "ema", T, s) @ E
    else:
        m = E[:, 0]
        rows = []
        for t in range(T):
            m = (1.0 - s) * m + s * E[:, t]
            rows.append(m)
        M = torch.stack(rows, 1)
    r = 1.0 / root
    return (E / (floor + M) ** alpha + delta) ** r - delta**r


def resize_bilinear_tf(x: torch.Tensor, out_h: int, out_w: int,
                       impl: str = "matmul") -> torch.Tensor:
    """tf.image.resize bilinear (half-pixel, align_corners=False) of x
    (B, H, W). impl "matmul": two 2-tap weight products (the JAX default,
    the width product skipped where W = out_w); "gather": the indexed form."""
    B, H, W = x.shape
    if impl == "matmul":
        out = _on(x.device, "resize", H, out_h) @ x
        if out_w != W:
            out = out @ _on(x.device, "resize", W, out_w).T
        return out
    if impl != "gather":
        raise ValueError(f"impl must be 'matmul' or 'gather', got {impl!r}")
    h0, h1, hf = (torch.as_tensor(a, device=x.device) for a in _axis_weights(H, out_h))
    w0, w1, wf = (torch.as_tensor(a, device=x.device) for a in _axis_weights(W, out_w))
    top = x[:, h0][:, :, w0] * (1 - wf) + x[:, h0][:, :, w1] * wf
    bot = x[:, h1][:, :, w0] * (1 - wf) + x[:, h1][:, :, w1] * wf
    return top * (1 - hf)[:, None] + bot * hf[:, None]


def hear_preprocess(audio: torch.Tensor) -> torch.Tensor:
    """(B, N) waveform at 16 kHz -> (B, 192, 128) mel-PCEN, float32 on the
    waveform's device (audio_utils.preprocess_audio). A clip shorter than
    32000 samples is zero-padded first."""
    B, N = audio.shape
    x = audio.to(torch.float32)
    if N < N_SAMPLES:
        x = torch.nn.functional.pad(x, (0, N_SAMPLES - N))
    x = x - x.amin(1, keepdim=True)
    x = x / (x.amax(1, keepdim=True) + 1e-8)
    x = x * 2.0 - 1.0
    n_frames = -(-N_SAMPLES // HOP)
    frames = frame_signal(x, FRAME, HOP, n_frames)  # (B, 200, 400), pad_end
    re = frames @ _on(x.device, "cos", FRAME)
    im = frames @ _on(x.device, "sin", FRAME)
    mel = (re * re + im * im) @ _on(x.device, "mel")
    return resize_bilinear_tf(pcen(mel), *OUT_HW)
