"""First-party emobase-988 functional features (the openSMILE fallback) —
a copy of heart_murmur_detection_tpu/audio/emobase.py, pinned to it by
tests/test_torch_emobase.py.

The reference's openSMILE path (src/benchmark/baseline/extract_feature.py:19-27)
delegates to the optional pip ``opensmile`` package (emobase feature set,
Functionals level: 26 low-level descriptors + their deltas, 19 statistical
functionals = 988 features). When that package is absent, this module provides
a self-contained numpy implementation of the same feature *family* — identical
dimensionality (988), the same LLD/functional recipe published in emobase.conf,
and openSMILE-style feature names:

  LLDs (26, 25 ms Hamming frames @ 10 ms, sma-smoothed window 3):
    intensity, loudness, mfcc[1..12], lspFreq[0..7], zcr,
    voicingProb, F0 (ACF pitch), F0env (held envelope)
  deltas: first-order regression deltas (window 2) of each smoothed LLD
  functionals (19): max, min, range, maxPos, minPos, amean,
    linregc1, linregc2, linregerrA, linregerrQ, stddev, skewness,
    kurtosis, quartile1, quartile2, quartile3, iqr1-2, iqr2-3, iqr1-3

This is a capability fallback, NOT a bit-parity port of openSMILE's C++ DSP:
values are correlated but not identical, and the column ordering is this
module's own — features extracted with the pip package and with this
fallback must not be mixed inside one probe. Runs on host numpy: it is a
per-file CPU path in the reference too (opensmile is a CPU library), and
the 988-d output feeds the same probe either way.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

FRAME_SEC = 0.025
HOP_SEC = 0.010
PREEMPH = 0.97
N_MEL = 26
N_MFCC = 12
LIFTER = 22
LPC_ORDER = 8
F0_MIN = 50.0
F0_MAX = 500.0
VOICING_CUTOFF = 0.55

_FUNCTIONAL_NAMES = (
    "max", "min", "range", "maxPos", "minPos", "amean",
    "linregc1", "linregc2", "linregerrA", "linregerrQ",
    "stddev", "skewness", "kurtosis",
    "quartile1", "quartile2", "quartile3",
    "iqr1-2", "iqr2-3", "iqr1-3",
)

_LLD_NAMES = (
    ["intensity", "loudness"]
    + [f"mfcc[{i}]" for i in range(1, N_MFCC + 1)]
    + [f"lspFreq[{i}]" for i in range(LPC_ORDER)]
    + ["zcr", "voicingProb", "F0", "F0env"]
)


def _frame(x: np.ndarray, flen: int, hop: int) -> np.ndarray:
    n = 1 + max(0, (len(x) - flen)) // hop
    idx = np.arange(flen)[None, :] + hop * np.arange(n)[:, None]
    return x[idx]


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def _mel_fbank(sr: int, n_fft: int, n_mel: int) -> np.ndarray:
    fmax = min(8000.0, sr / 2.0)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(20.0), _hz_to_mel(fmax), n_mel + 2))
    bins = np.floor((n_fft + 1) * pts / sr).astype(int)
    fb = np.zeros((n_mel, n_fft // 2 + 1))
    for i in range(n_mel):
        lo, c, hi = bins[i], bins[i + 1], bins[i + 2]
        if c > lo:
            fb[i, lo:c] = (np.arange(lo, c) - lo) / (c - lo)
        if hi > c:
            fb[i, c:hi] = (hi - np.arange(c, hi)) / (hi - c)
    return fb


def _levinson(r: np.ndarray, order: int) -> np.ndarray:
    """Batched Levinson-Durbin. r: (T, order+1) autocorrelations ->
    (T, order+1) LPC polynomials A(z) = 1 + a1 z^-1 + ... (sign convention
    such that the prediction filter is A)."""
    T = r.shape[0]
    a = np.zeros((T, order + 1))
    a[:, 0] = 1.0
    err = r[:, 0].copy()
    err = np.where(err <= 0, 1.0, err)
    for i in range(1, order + 1):
        acc = (a[:, :i] * r[:, i - np.arange(i)]).sum(axis=1)
        k = -acc / err
        a_new = a.copy()
        a_new[:, 1 : i + 1] = a[:, 1 : i + 1] + k[:, None] * a[:, i - 1 :: -1][:, :i]
        a = a_new
        err = err * (1.0 - k * k)
        err = np.where(err <= 1e-12, 1e-12, err)
    return a


def _poly_div(p: np.ndarray, root: float) -> np.ndarray:
    """Batched synthetic division of polynomials (T, n+1) by (z - root)."""
    T, n1 = p.shape
    out = np.zeros((T, n1 - 1))
    acc = np.zeros(T)
    for j in range(n1 - 1):
        acc = p[:, j] + root * acc
        out[:, j] = acc
    return out


def _lsp(a: np.ndarray) -> np.ndarray:
    """Line spectral frequencies (radians, ascending) from LPC polys.

    P(z) = A(z) + z^-(p+1) A(1/z) has a root at z=-1; Q(z) = A(z) -
    z^-(p+1) A(1/z) has one at z=+1 (even p). Deflate those, take the
    angles of the remaining unit-circle roots via batched companion
    eigenvalues, interleave."""
    T, n1 = a.shape
    p = n1 - 1
    P = np.concatenate([a, np.zeros((T, 1))], axis=1)
    P = P + P[:, ::-1]
    Q = np.concatenate([a, np.zeros((T, 1))], axis=1)
    Q = Q - Q[:, ::-1]
    P = _poly_div(P, -1.0)  # degree p
    Q = _poly_div(Q, 1.0)
    angles = []
    for poly in (P, Q):
        lead = poly[:, :1].copy()
        lead[np.abs(lead) < 1e-12] = 1.0
        monic = poly / lead
        deg = monic.shape[1] - 1
        comp = np.zeros((T, deg, deg))
        comp[:, 1:, :-1] = np.eye(deg - 1)
        comp[:, 0, :] = -monic[:, 1:]
        roots = np.linalg.eigvals(comp)
        ang = np.abs(np.angle(roots))
        ang = np.sort(ang, axis=1)[:, ::2]  # conjugate pairs -> unique
        angles.append(ang)
    lsf = np.sort(np.concatenate(angles, axis=1), axis=1)
    return lsf[:, :p]


def _acf_pitch(frames: np.ndarray, sr: int) -> Tuple[np.ndarray, np.ndarray]:
    """Normalized-ACF pitch per frame -> (F0 Hz with 0 for unvoiced,
    voicing probability)."""
    flen = frames.shape[1]
    fr = frames - frames.mean(axis=1, keepdims=True)
    n_fft = 1 << int(np.ceil(np.log2(2 * flen)))
    # dtype choice is a measured pocketfft quirk: rfft is ~8x slower in f32
    # than f64 at these padded power-of-2 sizes, while irfft is ~40x slower
    # in f64 than in complex64 — so transform up in f64, come back in c64
    spec = np.fft.rfft(fr.astype(np.float64), n_fft, axis=1)
    # real^2+imag^2 instead of spec*conj(spec): the complex multiply is
    # ~15x slower than the two real squarings for the same result
    power = (spec.real**2 + spec.imag**2).astype(np.float32)
    acf = np.fft.irfft(power.astype(np.complex64), n_fft, axis=1)[:, :flen]
    e0 = acf[:, 0].copy()
    e0[e0 <= 0] = 1.0
    acf = acf / e0[:, None]
    # unbiased lag normalization: the zero-padded linear ACF of a periodic
    # signal tapers as (N-lag)/N, which would depress voicingProb. The raw
    # correction flen/(flen-lag) is unbounded near lag=flen and would amplify
    # noise ~5x at lag_hi, pushing unvoiced frames over VOICING_CUTOFF — cap
    # it at 2.0 (the lag=flen/2 value), which covers the whole F0 search
    # range at 16 kHz while keeping the noise floor bounded.
    lags = np.arange(flen, dtype=np.float64)
    acf = acf * np.minimum(flen / np.maximum(flen - lags, 1.0), 2.0)[None, :]
    lag_lo = max(2, int(sr / F0_MAX))
    lag_hi = min(flen - 2, int(sr / F0_MIN))
    if lag_hi <= lag_lo:
        z = np.zeros(len(frames))
        return z, z
    window = acf[:, lag_lo : lag_hi + 1]
    best = np.argmax(window, axis=1)
    vp = np.clip(window[np.arange(len(frames)), best], 0.0, 1.0)
    lag = (lag_lo + best).astype(np.float64)
    # parabolic interpolation around the ACF peak for sub-sample lag
    li = lag.astype(int)
    ok = (li > lag_lo) & (li < lag_hi)
    ym1 = acf[np.arange(len(frames)), np.clip(li - 1, 0, flen - 1)]
    y0 = acf[np.arange(len(frames)), li]
    yp1 = acf[np.arange(len(frames)), np.clip(li + 1, 0, flen - 1)]
    denom = ym1 - 2 * y0 + yp1
    shift = np.where(np.abs(denom) > 1e-12, 0.5 * (ym1 - yp1) / denom, 0.0)
    lag = lag + np.where(ok, np.clip(shift, -0.5, 0.5), 0.0)
    f0 = np.where(vp > VOICING_CUTOFF, sr / lag, 0.0)
    return f0, vp


def _delta(x: np.ndarray, w: int = 2) -> np.ndarray:
    """Regression deltas along axis 0 with replicate padding (HTK-style)."""
    pad = np.concatenate([x[:1].repeat(w, 0), x, x[-1:].repeat(w, 0)], axis=0)
    num = sum(n * (pad[w + n : len(x) + w + n] - pad[w - n : len(x) + w - n])
              for n in range(1, w + 1))
    return num / (2.0 * sum(n * n for n in range(1, w + 1)))


def _sma(x: np.ndarray, w: int = 3) -> np.ndarray:
    """Moving average (window 3) along axis 0, replicate edges — the 'sma'
    contour smoothing every emobase LLD passes through."""
    pad = np.concatenate([x[:1], x, x[-1:]], axis=0)
    return (pad[:-2] + pad[1:-1] + pad[2:]) / 3.0


def emobase_lld(wav: np.ndarray, sr: int) -> np.ndarray:
    """(T, 26) low-level descriptor matrix in `_LLD_NAMES` order."""
    x = np.asarray(wav, np.float32)
    flen = int(round(FRAME_SEC * sr))
    hop = int(round(HOP_SEC * sr))
    if len(x) < flen:
        x = np.pad(x, (0, flen - len(x)))
    frames = _frame(x, flen, hop)
    ham = np.hamming(flen).astype(np.float32)
    wframes = frames * ham

    # intensity / loudness (cIntensity: window-weighted mean power; loudness
    # is the Zwicker-style (I/I0)^0.3 approximation with I0=1)
    intensity = (ham * frames**2).sum(axis=1) / ham.sum()
    loudness = np.power(np.maximum(intensity, 0.0), 0.3)

    # MFCC 1..12 on pre-emphasized frames, 26 HTK-style mel bands, lifter 22
    pre = frames.copy()
    pre[:, 1:] -= PREEMPH * frames[:, :-1]
    pre[:, 0] *= 1.0 - PREEMPH
    pw = pre * ham
    n_fft = 1 << int(np.ceil(np.log2(flen)))
    fsp = np.fft.rfft(pw.astype(np.float64), n_fft, axis=1)
    pspec = fsp.real**2 + fsp.imag**2
    fb = _mel_fbank(sr, n_fft, N_MEL)
    melE = np.log(np.maximum(pspec @ fb.T, 1e-10))
    k = np.arange(N_MEL)
    dct = np.cos(np.pi * np.arange(1, N_MFCC + 1)[:, None] * (2 * k + 1) / (2 * N_MEL))
    mfcc = melE @ dct.T * np.sqrt(2.0 / N_MEL)
    lift = 1.0 + (LIFTER / 2.0) * np.sin(np.pi * np.arange(1, N_MFCC + 1) / LIFTER)
    mfcc = mfcc * lift

    # LSP from order-8 LPC of the pre-emphasized windowed frames
    # (same f64-rfft / c64-irfft pocketfft dtype quirk as _acf_pitch)
    nf = 1 << int(np.ceil(np.log2(2 * flen)))
    sp = np.fft.rfft(pw.astype(np.float64), nf, axis=1)
    spow = (sp.real**2 + sp.imag**2).astype(np.float32)
    ac = np.fft.irfft(
        spow.astype(np.complex64), nf, axis=1
    )[:, : LPC_ORDER + 1]
    lpc = _levinson(ac, LPC_ORDER)
    lsf = _lsp(lpc)

    zcr = (np.abs(np.diff(np.signbit(frames), axis=1)).sum(axis=1)) / (flen - 1)
    f0, vp = _acf_pitch(frames, sr)
    # F0env: hold the last voiced F0 (openSMILE's pitch envelope semantics)
    f0env = f0.copy()
    last = 0.0
    for t in range(len(f0env)):
        if f0env[t] > 0:
            last = f0env[t]
        else:
            f0env[t] = last

    lld = np.column_stack(
        [intensity, loudness, mfcc, lsf, zcr, vp, f0, f0env]
    )
    assert lld.shape[1] == len(_LLD_NAMES)
    return lld


def functionals(c: np.ndarray) -> np.ndarray:
    """The 19 emobase functionals of one contour c (T,) -> (19,)."""
    T = len(c)
    t = np.arange(T, dtype=np.float64)
    cmax, cmin = c.max(), c.min()
    mean = c.mean()
    if T > 1:
        denom = ((t - t.mean()) ** 2).sum()
        slope = ((t - t.mean()) * (c - mean)).sum() / denom
    else:
        slope = 0.0
    offset = mean - slope * t.mean()
    fit = offset + slope * t
    err = c - fit
    sd = c.std()
    if sd > 1e-12:
        z = (c - mean) / sd
        skew = (z**3).mean()
        kurt = (z**4).mean()
    else:
        skew, kurt = 0.0, 0.0
    q1, q2, q3 = np.percentile(c, [25, 50, 75])
    rel = 1.0 / max(T - 1, 1)
    return np.array(
        [
            cmax, cmin, cmax - cmin,
            float(np.argmax(c)) * rel, float(np.argmin(c)) * rel,
            mean, slope, offset,
            np.abs(err).mean(), (err**2).mean(),
            sd, skew, kurt,
            q1, q2, q3, q2 - q1, q3 - q2, q3 - q1,
        ]
    )


def emobase_feature_names() -> List[str]:
    names = []
    for lld in _LLD_NAMES:
        for suffix in ("sma", "sma_de"):
            for f in _FUNCTIONAL_NAMES:
                names.append(f"{lld}_{suffix}_{f}")
    return names


def emobase_features(wav: np.ndarray, sr: int) -> np.ndarray:
    """988-d emobase-style functional vector for one clip.

    Layout: for each of the 26 LLDs, the 19 functionals of its smoothed
    contour then of its delta contour (matching `emobase_feature_names`)."""
    lld = _sma(emobase_lld(wav, sr))
    dlld = _delta(lld)
    out = np.empty(lld.shape[1] * 2 * len(_FUNCTIONAL_NAMES))
    k = 0
    for j in range(lld.shape[1]):
        for contour in (lld[:, j], dlld[:, j]):
            out[k : k + len(_FUNCTIONAL_NAMES)] = functionals(contour)
            k += len(_FUNCTIONAL_NAMES)
    return out.astype(np.float32)
