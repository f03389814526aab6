"""Host<->device wire formats for waveform transfer (counterpart of
heart_murmur_detection_tpu/audio/wire.py).

  f32    4 B/sample  lossless
  int16  2 B/sample  exact for 16-bit-sourced PCM (the usual case)
  mulaw  1 B/sample  8-bit mu-law companding (G.711-style, mu=255)

`encode_np` is a numpy copy of the original; `decode_device` runs on torch
tensors on whichever device they live.
"""

from __future__ import annotations

import numpy as np
import torch

_MU = 255.0


def encode_np(x: np.ndarray, wire: str) -> np.ndarray:
    """Pack a float waveform (values in [-1, 1]) for transfer."""
    if wire == "f32":
        return x.astype(np.float32, copy=False)
    if wire == "int16":
        if x.dtype == np.int16:
            return x
        return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    if wire == "mulaw":
        if x.dtype == np.int16:
            x = x.astype(np.float32) / 32768.0
        x = np.clip(x, -1.0, 1.0)
        y = np.sign(x) * np.log1p(_MU * np.abs(x)) / np.log1p(_MU)
        return ((y + 1.0) / 2.0 * _MU + 0.5).astype(np.uint8)
    raise ValueError(f"unknown wire format {wire!r}")


def wire_dtype(wire: str):
    return {"f32": np.float32, "int16": np.int16, "mulaw": np.uint8}[wire]


def decode_device(w: torch.Tensor, wire: str) -> torch.Tensor:
    """Unpack a wire-format batch to float32 on its device."""
    if wire == "f32":
        return w.to(torch.float32)
    if wire == "int16":
        return w.to(torch.float32) / 32768.0
    if wire == "mulaw":
        x = w.to(torch.float32) / _MU * 2.0 - 1.0
        return torch.sign(x) / _MU * (torch.pow(1.0 + _MU, x.abs()) - 1.0)
    raise ValueError(f"unknown wire format {wire!r}")
