"""Pure-numpy DSP pieces the port needs: the periodic Hann window and the
slaney mel filterbank (constants of the device mel frontend), the symmetric
Hanning window and the kaldi mel banks (constants of the kaldi fbank
frontend), the librosa-semantics silence trim (host pipeline), and the host
mel and kaldi fbank of the fine-tuning spectrogram cache
(pre_process_audio_mel_t, kaldi_fbank).

A copy of the matching functions of heart_murmur_detection_tpu/audio/
reference_np.py, which cannot be imported without jax;
tests/test_torch_dsp.py pins each copy to its original.

Reference semantics:
- ``librosa.filters.mel(htk=False, norm='slaney')``
- ``torchaudio.compliance.kaldi.get_mel_banks`` defaults
- ``librosa.effects.trim(frame_length=sr/10, hop=frame/2)`` (src/util.py:237-243)
- ``librosa.feature.melspectrogram`` + ``power_to_db`` + min-max (src/util.py:481-501)
- ``torchaudio.compliance.kaldi.fbank`` (dither 0)
"""

from __future__ import annotations

import numpy as np


def hann_periodic(n: int) -> np.ndarray:
    """Periodic ("DFT-even") Hann window, as scipy get_window('hann', n, fftbins=True)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float64)


def hanning_symmetric(n: int) -> np.ndarray:
    """Kaldi 'hanning' window: 0.5 - 0.5 cos(2 pi k /(n-1))."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))).astype(np.float64)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = f >= min_log_hz
    mels = np.where(log_t, min_log_mel + np.log(np.maximum(f, 1e-12) / min_log_hz) / logstep, mels)
    return mels


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = m >= min_log_mel
    freqs = np.where(log_t, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)
    return freqs


def mel_filterbank_slaney(
    sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float
) -> np.ndarray:
    """Slaney-style mel filterbank with slaney area-normalisation.

    Matches librosa.filters.mel(htk=False, norm='slaney').
    Returns (n_mels, 1 + n_fft//2) float32.
    """
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_min, mel_max = _hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax)
    mels = np.linspace(mel_min, mel_max, n_mels + 2)
    mel_f = _mel_to_hz_slaney(mels)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def _mel_htk(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def kaldi_mel_banks(
    num_bins: int,
    padded_window_size: int,
    sr: float,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """Kaldi mel banks (triangles in HTK-mel space over FFT bin centres).

    Matches torchaudio.compliance.kaldi.get_mel_banks defaults.
    Returns (num_bins, padded_window_size // 2): the nyquist bin is excluded.
    """
    num_fft_bins = padded_window_size // 2
    nyquist = 0.5 * sr
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    fft_bin_width = sr / padded_window_size
    mel_low = _mel_htk(low_freq)
    mel_high = _mel_htk(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bins = np.arange(num_bins)[:, None]
    left_mel = mel_low + bins * mel_delta
    center_mel = mel_low + (bins + 1) * mel_delta
    right_mel = mel_low + (bins + 2) * mel_delta

    freqs = fft_bin_width * np.arange(num_fft_bins)[None, :]
    mel = _mel_htk(freqs)
    up_slope = (mel - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mel) / (right_mel - center_mel)
    banks = np.maximum(0.0, np.minimum(up_slope, down_slope))
    return banks.astype(np.float32)


def _rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    pad = frame_length // 2
    yp = np.pad(np.asarray(y, dtype=np.float32), (pad, pad), mode="constant")
    n_frames = 1 + (len(yp) - frame_length) // hop_length
    idx = np.arange(frame_length)[None, :] + hop_length * np.arange(n_frames)[:, None]
    return np.sqrt(np.mean(yp[idx] ** 2, axis=1))


def trim_silence(
    y: np.ndarray,
    frame_length: int,
    hop_length: int,
    top_db: float = 60.0,
):
    """librosa.effects.trim: drop leading/trailing frames quieter than
    (max frame power) - top_db. Returns (trimmed, (start, end))."""
    mse = _rms(y, frame_length, hop_length) ** 2
    db = 10.0 * np.log10(np.maximum(1e-10, mse))
    db -= 10.0 * np.log10(np.maximum(1e-10, mse.max()))
    nonsilent = np.flatnonzero(db > -top_db)
    if nonsilent.size > 0:
        start = int(nonsilent[0] * hop_length)
        end = min(len(y), int((nonsilent[-1] + 1) * hop_length))
    else:
        start, end = 0, 0
    return y[start:end], (start, end)


def trim_heart(y: np.ndarray, sr: int = 16000):
    """Trim with the reference's frame/hop choice: frame=sr/10, hop=frame/2
    (src/util.py:237-243)."""
    frame = int(sr / 10)
    return trim_silence(y, frame, frame // 2)


# ---------------------------------------------------------------------------
# STFT / mel pipeline (librosa semantics)
# ---------------------------------------------------------------------------


def stft_power(y: np.ndarray, n_fft: int = 1024, hop: int = 512) -> np.ndarray:
    """|STFT|^2 with center=True, pad_mode='constant' (librosa 0.10 defaults).

    Returns (1 + n_fft//2, n_frames).
    """
    y = np.asarray(y, dtype=np.float32)
    pad = n_fft // 2
    yp = np.pad(y, (pad, pad), mode="constant")
    n_frames = 1 + (len(yp) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = yp[idx] * hann_periodic(n_fft)[None, :]
    spec = np.fft.rfft(frames, n=n_fft, axis=1)
    return (np.abs(spec) ** 2).T.astype(np.float32)


def melspectrogram(
    y: np.ndarray,
    sr: int = 16000,
    n_mels: int = 64,
    fmin: float = 50.0,
    fmax: float = 8000.0,
    n_fft: int = 1024,
    hop: int = 512,
) -> np.ndarray:
    """librosa.feature.melspectrogram (power=2). Returns (n_mels, n_frames)."""
    S = stft_power(y, n_fft, hop)
    fb = mel_filterbank_slaney(sr, n_fft, n_mels, fmin, fmax)
    return fb @ S


def power_to_db(S: np.ndarray, ref: float, amin: float = 1e-10, top_db: float = 80.0):
    """librosa.power_to_db semantics."""
    log_spec = 10.0 * np.log10(np.maximum(amin, S))
    log_spec -= 10.0 * np.log10(np.maximum(amin, ref))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def pre_process_audio_mel_t(
    audio: np.ndarray,
    sample_rate: int = 16000,
    n_mels: int = 64,
    f_min: float = 50.0,
    f_max: float = 2000.0,
    nfft: int = 1024,
    hop: int = 512,
) -> np.ndarray:
    """Whole mel frontend == src/util.py:481-501 (note callers pass f_max=8000).

    mel power -> power_to_db(ref=max) -> per-clip min-max -> (T, n_mels).
    """
    S = melspectrogram(audio, sample_rate, n_mels, f_min, f_max, nfft, hop)
    S = power_to_db(S, ref=float(S.max()))
    lo, hi = float(S.min()), float(S.max())
    if hi != lo:
        S = (S - lo) / (hi - lo)
    return S.T.astype(np.float32)


# ---------------------------------------------------------------------------
# Kaldi fbank (torchaudio.compliance.kaldi.fbank semantics, dither=0)
# ---------------------------------------------------------------------------


def kaldi_fbank(
    waveform: np.ndarray,
    sample_rate: int = 16000,
    num_mel_bins: int = 128,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    preemphasis: float = 0.97,
    remove_dc_offset: bool = True,
) -> np.ndarray:
    """Log-mel filterbank energies, kaldi style (snip_edges=True, hanning window,
    use_energy=False, htk_compat=True, dither=0). Returns (n_frames, num_mel_bins).

    Note the reference subtracts the waveform mean *before* calling fbank
    (src/util.py:841); that is the caller's job, not done here.
    """
    y = np.asarray(waveform, dtype=np.float64)
    win = int(sample_rate * frame_length_ms / 1000)
    shift = int(sample_rate * frame_shift_ms / 1000)
    padded = 1 << (win - 1).bit_length()  # next pow2, kaldi round_to_power_of_two

    if len(y) < win:
        return np.zeros((0, num_mel_bins), dtype=np.float32)
    n_frames = 1 + (len(y) - win) // shift
    idx = np.arange(win)[None, :] + shift * np.arange(n_frames)[:, None]
    frames = y[idx]

    if remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if preemphasis != 0.0:
        prev = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - preemphasis * prev
    frames = frames * hanning_symmetric(win)[None, :]

    fr = np.zeros((n_frames, padded), dtype=np.float64)
    fr[:, :win] = frames
    spec = np.fft.rfft(fr, axis=1)
    power = np.abs(spec) ** 2  # (n_frames, padded//2 + 1)

    banks = kaldi_mel_banks(num_mel_bins, padded, sample_rate)  # excludes nyquist
    mel_e = power[:, : padded // 2] @ banks.T.astype(np.float64)
    mel_e = np.log(np.maximum(mel_e, np.finfo(np.float32).eps))
    return mel_e.astype(np.float32)
