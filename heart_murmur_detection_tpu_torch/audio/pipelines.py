"""Host-side clip pipelines: decode -> trim -> pad-to-min -> cap, or split.

A copy of `_load_trim`, `get_entire_signal`, `get_split_signal` and
`get_split_signal_fbank_pad` from heart_murmur_detection_tpu/audio/
pipelines.py (src/util.py:205-267, 309-364, 794-860), trimmed to the
options the extraction, fine-tuning and SSL preparation paths use (no
bandpass filter: the chunked MAE path calls `_load_trim` as the JAX
`_chunks` does, and the fine-tuning cache and pretrain/prepare.py the
other paths, with none). `get_entire_signal` keeps the JAX signature's
`yt=` entry for a waveform already in memory (the ICBHI respiratory cycles
of pretrain/prepare.py). The original cannot be imported without jax.
tests/test_torch_dsp.py and tests/test_torch_legacy.py pin the copies to
the originals.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..utils.audio_io import load_wav
from . import reference_np as ref
from .pad import decide_droplast, split_pad_sample

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
    spectrogram: bool = False,
    yt: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """Whole-clip path (src/util.py:205-267): trim, pad-to-min, cap at
    max_sec; `yt` skips the load and trim.

    Returns the waveform, or its (T, 64) normalised mel (f_max 8000) with
    spectrogram=True, or None when it is too short and pad=False.
    """
    if yt is None:
        yt = _load_trim(path, sample_rate)
    duration = len(yt) / sample_rate
    if duration < input_sec:
        if not pad:
            return None
        yt = split_pad_sample(yt, input_sec, sample_rate, types)[0]
    if max_sec and duration > max_sec:
        yt = yt[: int(max_sec * sample_rate)]
    if spectrogram:
        return ref.pre_process_audio_mel_t(yt, sample_rate, f_max=8000)
    return yt


def get_split_signal(
    path: str,
    input_sec: float = 8,
    sample_rate: int = SR,
    spectrogram: bool = False,
    trim_tail: bool = False,
) -> List[np.ndarray]:
    """Chunked path (src/util.py:309-364): 50%-hop input_sec windows, or
    each window's (T, 64) normalised mel (f_max 8000) with spectrogram=True."""
    yt = _load_trim(path, sample_rate)
    drop_last = decide_droplast(len(yt), sample_rate, input_sec) if trim_tail else False
    chunks = split_pad_sample(yt, input_sec, sample_rate)
    if drop_last:
        chunks.pop()
    if not spectrogram:
        return chunks
    return [ref.pre_process_audio_mel_t(c, sample_rate, f_max=8000) for c in chunks]


def get_split_signal_fbank_pad(
    path: str,
    input_sec: float = 10,
    sample_rate: int = SR,
    spectrogram: bool = True,
    trim_tail: bool = False,
) -> List[np.ndarray]:
    """Kaldi-fbank chunked path (src/util.py:794-860): mean-subtract then
    128-bin fbank per chunk; chunks shorter than 400 samples dropped."""
    yt = _load_trim(path, sample_rate)
    drop_last = decide_droplast(len(yt), sample_rate, input_sec) if trim_tail else False
    chunks = split_pad_sample(yt, input_sec, sample_rate)
    if drop_last:
        chunks.pop()
    if not spectrogram:
        return chunks
    out = []
    for w in chunks:
        w = w - w.mean()
        if len(w) > 400:
            out.append(ref.kaldi_fbank(w, sample_rate))
    return out
