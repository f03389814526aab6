"""VGGish and its example-framing frontend, and the openSMILE baseline —
counterpart of heart_murmur_detection_tpu/models/vggish.py (`_mel_matrix`
:38, `waveform_to_examples` :55, `VGGish` :69, `VGGishPostprocessor` :87,
`extract_vgg_feature` :102, `opensmile_impl` :139,
`extract_opensmile_features` :156; the reference's
src/benchmark/baseline/vggish/ and extract_feature.py:19-75).

Frontend (host numpy, a copy of the JAX package's, bitwise equal to it):
16 kHz mono -> magnitude STFT (window 400, hop 160, periodic Hann, no
padding, FFT 512) -> 64 HTK-mel bands 125-7500 Hz -> log(mel + 0.01) ->
non-overlapping 0.96-s examples (96 frames x 64 bands).

Network: conv 64 - pool - conv 128 - pool - conv 256 x2 - pool - conv 512
x2 - pool (3x3 convolutions padded 1, ReLU, 2x2 max pools) - fc 4096 x2 -
fc 128, ReLU after every layer. Module names are the flax module's
(conv1_1 ... conv4_2, fc1_1, fc1_2, fc2), so extract/convert.py::
from_jax_vggish carries a JAX init. The flatten before fc1_1 is in the flax
NHWC order (6, 4, 512): the (B, 512, 6, 4) map is permuted to (B, 6, 4,
512) first. Weights are random (seeded) or passed in: the repository holds
no VGGish checkpoint and the JAX package names no default path.

extract_opensmile_features is the emobase-988 functional vector of one
file: the optional pip `opensmile` package when it is installed, else the
port's host numpy copy audio/emobase.py (opensmile_impl says which). It
returns a (1, 988) float array (the machine with the card has no pandas;
emobase_feature_names() names the fallback's columns).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

SR = 16000
FRAME = 400
HOP = 160
EX_FRAMES = 96  # 0.96 s / 10 ms
N_MELS = 64
EMB = 128
CONVS = (("conv1_1", 1, 64), ("conv2_1", 64, 128), ("conv3_1", 128, 256),
         ("conv3_2", 256, 256), ("conv4_1", 256, 512), ("conv4_2", 512, 512))
POOL_AFTER = ("conv1_1", "conv2_1", "conv3_2", "conv4_2")


def _hz_to_mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


@functools.lru_cache(maxsize=None)
def _mel_matrix() -> np.ndarray:
    """spectrogram_to_mel_matrix semantics (mel_features.py): triangles in
    mel space over the FFT bins' frequencies, 125-7500 Hz, unnormalised."""
    nfft = 512  # the next power of two of the 400-sample window
    n_bins = nfft // 2 + 1
    freqs = np.linspace(0, SR / 2.0, n_bins)
    spec_mel = _hz_to_mel(freqs)
    edges = np.linspace(_hz_to_mel(125.0), _hz_to_mel(7500.0), N_MELS + 2)
    lower, center, upper = edges[:-2], edges[1:-1], edges[2:]
    up = (spec_mel[:, None] - lower[None]) / (center - lower)[None]
    down = (upper[None] - spec_mel[:, None]) / (upper - center)[None]
    w = np.maximum(0.0, np.minimum(up, down)).astype(np.float32)
    w[0] = 0.0  # DC
    return w


def waveform_to_examples(y: np.ndarray) -> np.ndarray:
    """(N,) float waveform at 16 kHz -> (n_examples, 96, 64) log-mel
    examples (none when the clip is shorter than one example)."""
    n_frames = 1 + (len(y) - FRAME) // HOP if len(y) >= FRAME else 0
    if n_frames < EX_FRAMES:
        return np.zeros((0, EX_FRAMES, N_MELS), np.float32)
    idx = np.arange(FRAME)[None, :] + HOP * np.arange(n_frames)[:, None]
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(FRAME) / FRAME)
    frames = y[idx] * win
    spec = np.abs(np.fft.rfft(frames, n=512, axis=1))  # magnitude, not power
    mel = spec @ _mel_matrix()
    logmel = np.log(mel + 0.01)
    n_ex = n_frames // EX_FRAMES
    return logmel[: n_ex * EX_FRAMES].reshape(n_ex, EX_FRAMES, N_MELS).astype(np.float32)


class VGGish(nn.Module):
    """(B, 96, 64) log-mel examples -> (B, 128) embeddings."""

    def __init__(self):
        super().__init__()
        for name, ci, co in CONVS:
            setattr(self, name, nn.Conv2d(ci, co, 3, padding=1))
        self.fc1_1 = nn.Linear(6 * 4 * 512, 4096)
        self.fc1_2 = nn.Linear(4096, 4096)
        self.fc2 = nn.Linear(4096, EMB)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None]
        for name, _, _ in CONVS:
            h = F.relu(getattr(self, name)(h))
            if name in POOL_AFTER:
                h = F.max_pool2d(h, 2)
        h = h.permute(0, 2, 3, 1).flatten(1)  # the flax NHWC flatten (6, 4, 512)
        h = F.relu(self.fc1_1(h))
        h = F.relu(self.fc1_2(h))
        return F.relu(self.fc2(h))


def init_weights(model: VGGish, generator: torch.Generator) -> VGGish:
    """Seeded random weights drawn only from `generator` (lecun-normal
    convolution and matmul weights, zero biases: models/htsat.py::
    init_weights)."""
    from .htsat import init_weights as lecun

    lecun(model, generator)
    return model


class VGGishPostprocessor:
    """PCA whitening and 8-bit quantisation (vggish_postprocess semantics);
    the parameters from a vggish_pca_params.npz file."""

    def __init__(self, pca_params_path: str):
        d = np.load(pca_params_path)
        self.pca_matrix = d["pca_eigen_vectors"]
        self.pca_means = d["pca_means"].reshape(-1, 1)

    def __call__(self, emb: np.ndarray) -> np.ndarray:
        x = self.pca_matrix @ (emb.T - self.pca_means)
        x = np.clip(x.T, -2.0, 2.0)
        return np.round((x + 2.0) * (255.0 / 4.0))


@torch.no_grad()
def extract_vgg_feature(
    paths: Sequence[str],
    model: Optional[VGGish] = None,
    random_init: bool = False,
    batch_size: int = 64,
    device="cuda",
) -> np.ndarray:
    """The mean example embedding of each file, (N, 128) float32
    (extract_feature.py:30-75; the JAX extract_vgg_feature's policy): each
    file decoded at 16 kHz and framed into examples, the examples of all
    files run in batches of batch_size padded with zero examples, a file
    with no example gives zeros(128). The network runs in float32 with TF32
    off. model: a VGGish with weights, else seed-0 random weights with
    random_init; without either, FileNotFoundError. device "cuda" without a
    card raises."""
    from ..utils.audio_io import load_wav
    from ..utils.precision import strict_f32

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("extract_vgg_feature(device='cuda'): no CUDA card available")
    if model is None:
        if not random_init:
            raise FileNotFoundError("VGGish weights not available; pass model= or random_init")
        model = init_weights(VGGish(), torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    examples = [waveform_to_examples(load_wav(str(p), sr=SR)[0]) for p in paths]
    counts = [len(e) for e in examples]
    ex = np.concatenate(examples) if examples else np.zeros((0, EX_FRAMES, N_MELS), np.float32)
    pad = (-len(ex)) % batch_size
    if pad:
        ex = np.concatenate([ex, np.zeros((pad, EX_FRAMES, N_MELS), np.float32)])
    embs = []
    with strict_f32():
        for lo in range(0, len(ex), batch_size):
            xb = torch.from_numpy(ex[lo: lo + batch_size]).to(device)
            embs.append(model(xb).cpu().numpy())
    embs = np.concatenate(embs) if embs else np.zeros((0, EMB), np.float32)
    out = np.zeros((len(counts), EMB), np.float32)
    at = 0
    for i, n in enumerate(counts):
        if n:
            out[i] = embs[at: at + n].mean(axis=0)
        at += n
    return out


def opensmile_impl() -> str:
    """Which openSMILE implementation extract_opensmile_features uses:
    "pip-opensmile" (exact reference parity) or "native-emobase" (the
    first-party fallback). Feature caches record it, so features of the two
    are never mixed in one probe unknowingly."""
    try:
        import opensmile  # noqa: F401

        return "pip-opensmile"
    except ImportError:
        return "native-emobase"


_warned_fallback = False


def extract_opensmile_features(audio_file: str, native: Optional[bool] = None) -> np.ndarray:
    """openSMILE emobase functionals of one file (extract_feature.py:19-27)
    as a (1, 988) float array: the pip `opensmile` package when installed,
    else the audio/emobase.py fallback (the same dimensionality and recipe,
    not bit-identical to openSMILE's C++ DSP). native=True forces the
    fallback, native=False requires the pip package."""
    if not native:
        try:
            import opensmile

            smile = opensmile.Smile(
                feature_set=opensmile.FeatureSet.emobase,
                feature_level=opensmile.FeatureLevel.Functionals,
            )
            return np.asarray(smile.process_file(audio_file))
        except ImportError:
            if native is False:
                raise
    global _warned_fallback
    if native is None and not _warned_fallback:
        import warnings

        warnings.warn(
            "pip 'opensmile' not installed: using the first-party emobase fallback "
            "(audio/emobase.py). Values are correlated but not bit-identical to openSMILE; "
            "do not mix the two inside one probe (opensmile_impl() reports which is active).",
            stacklevel=2,
        )
        _warned_fallback = True
    from ..audio.emobase import emobase_features
    from ..utils.audio_io import load_wav

    wav, sr = load_wav(audio_file, sr=None)
    return emobase_features(wav, sr)[None, :]
