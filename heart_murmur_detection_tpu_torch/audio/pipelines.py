"""Host-side whole-clip pipeline: decode -> trim -> pad-to-min -> cap.

A copy of `_load_trim` and `get_entire_signal` from
heart_murmur_detection_tpu/audio/pipelines.py (src/util.py:205-267), trimmed to
the options the extraction paths use (no bandpass filter: the chunked MAE
path calls `_load_trim` as the JAX `_chunks` does, with none); the original
cannot be imported without jax. tests/test_torch_dsp.py pins the copy to the
original.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.audio_io import load_wav
from . import reference_np as ref
from .pad import split_pad_sample

SR = 16000


def _load_trim(path: str, sample_rate: int) -> np.ndarray:
    data, rate = load_wav(path, sr=sample_rate)
    yt, _ = ref.trim_heart(data, rate)
    return yt


def get_entire_signal(
    path: str,
    input_sec: float = 8,
    sample_rate: int = SR,
    pad: bool = False,
    types: str = "repeat",
    max_sec: Optional[float] = None,
) -> Optional[np.ndarray]:
    """Whole-clip path (src/util.py:205-267): trim, pad-to-min, cap at max_sec.

    Returns the waveform, or None when it is too short and pad=False.
    """
    yt = _load_trim(path, sample_rate)
    duration = len(yt) / sample_rate
    if duration < input_sec:
        if not pad:
            return None
        yt = split_pad_sample(yt, input_sec, sample_rate, types)[0]
    if max_sec and duration > max_sec:
        yt = yt[: int(max_sec * sample_rate)]
    return yt
