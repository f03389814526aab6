"""Host-side audio decode.

A copy of heart_murmur_detection_tpu/utils/audio_io.py (the original cannot be
imported without jax); tests/test_torch_dsp.py pins it to the original.

The reference delegates decode+resample to ``librosa.load`` (src/util.py:222-224,
which itself wraps soundfile/audioread). Neither librosa nor soundfile is a
dependency here; WAV parsing is first-party (stdlib ``wave`` cannot read float
WAVs, so we parse RIFF directly) and resampling is a polyphase filter via scipy.

All returned audio is float32 mono in [-1, 1], matching ``librosa.load``
semantics (mean over channels for mono conversion, sample-width scaling).
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np
from scipy.signal import resample_poly

_PCM_SCALE = {1: 1 << 7, 2: 1 << 15, 3: 1 << 23, 4: 1 << 31}


def _parse_riff(raw: bytes) -> Tuple[dict, bytes]:
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    n = len(raw)
    while pos + 8 <= n:
        cid = raw[pos : pos + 4]
        (size,) = struct.unpack("<I", raw[pos + 4 : pos + 8])
        body = raw[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            (audio_format, channels, sr, _br, _ba, bits) = struct.unpack(
                "<HHIIHH", body[:16]
            )
            if audio_format == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                (audio_format,) = struct.unpack("<H", body[24:26])
            fmt = dict(format=audio_format, channels=channels, sr=sr, bits=bits)
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or data is None:
        raise ValueError("WAV missing fmt/data chunk")
    return fmt, data


def load_wav(path: str, sr: Optional[int] = 16000) -> Tuple[np.ndarray, int]:
    """Read a WAV file; resample to ``sr`` if given. Returns (float32 array, rate).

    Mirrors ``librosa.load(path, sr=sr)``: mono via channel mean, output in
    [-1, 1], high-quality polyphase resampling.
    """
    with open(path, "rb") as f:
        raw = f.read()
    fmt, data = _parse_riff(raw)
    ch, bits, native_sr = fmt["channels"], fmt["bits"], fmt["sr"]
    if fmt["format"] == 3:  # IEEE float
        dtype = np.float32 if bits == 32 else np.float64
        x = np.frombuffer(data, dtype=dtype).astype(np.float32)
    elif fmt["format"] == 1:  # PCM
        if bits == 8:
            x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float32) / _PCM_SCALE[2]
        elif bits == 24:
            b = np.frombuffer(data, dtype=np.uint8)
            b = b[: (len(b) // 3) * 3].reshape(-1, 3)
            vals = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= (1 << 23), vals - (1 << 24), vals)
            x = vals.astype(np.float32) / _PCM_SCALE[3]
        elif bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(np.float32) / _PCM_SCALE[4]
        else:
            raise ValueError(f"unsupported PCM width: {bits}")
    else:
        raise ValueError(f"unsupported WAV format code: {fmt['format']}")

    if ch > 1:
        x = x[: (len(x) // ch) * ch].reshape(-1, ch)
        x = x.mean(axis=1)

    rate = native_sr
    if sr is not None and sr != native_sr:
        g = np.gcd(int(sr), int(native_sr))
        x = resample_poly(x, sr // g, native_sr // g, axis=-1).astype(np.float32)
        rate = sr
    return np.ascontiguousarray(x, dtype=np.float32), rate


def write_wav(path: str, x: np.ndarray, sr: int) -> None:
    """Write mono/stereo float32 audio as 16-bit PCM WAV (for tests/fixtures)."""
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    pcm = np.clip(x * 32767.0, -32768, 32767).astype("<i2")
    data = pcm.tobytes()
    ch = x.shape[1]
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, ch, sr, sr * ch * 2, ch * 2, 16)
    hdr += b"data" + struct.pack("<I", len(data))
    with open(path, "wb") as f:
        f.write(hdr + data)
