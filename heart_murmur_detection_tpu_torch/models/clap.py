"""Microsoft CLAP audio tower — counterpart of
heart_murmur_detection_tpu/models/clap.py (`CLAPConfig` :32, `Projection`
:55, `CLAPAudioEncoder` :67, `clap_audio_forward_fused` :94,
`load_clap_clip` :137, `extract_clap_feature` :153; the reference's
msclap CLAPWrapper.py:343 and models/clap.py:25-141), audio side only.

- 2022: models/cnn14.py::Cnn14 at 44.1 kHz (n_fft 1024, hop 320, 64 mels,
  fmin 50, fmax 14000), 2048-d embedding, 5-s clips;
- 2023: models/htsat.py::HTSAT (HTSATConfig(mel_bins=64), the operaCT
  geometry) at 44.1 kHz (fmax 8000), embedding = latent_output, 7-s clips;
- the projection ln(e1 + dropout(gelu(e1) W2)) with e1 = x W1, both
  products without bias, to 1024 (clap.py:10-22; the dropout, p 0.5, only
  in train mode);
- clip loading: short clips tiled, long ones randomly cropped
  (CLAPWrapper.load_audio_into_tensor:274-299).

Module names are msclap's audio_encoder subtree (base.htsat.* for 2023,
base.conv_block{i}.* for 2022, projection.linear1 / linear2 / layer_norm),
so an msclap state_dict loads by name (extract/convert.py::load_clap_ckpt).
`CLAPAudioEncoder.forward` is the strict float32 graph; the 2023
extraction flow is `clap_audio_forward_fused`, whose swin blocks are the
CUDA kernels swin_attn / swin_mlp on a card (TPU K1-K3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..audio.dsp import logmel_frontend_general
from . import htsat as htsat_mod
from .cnn14 import Cnn14
from .htsat import HTSAT, HTSATConfig


@dataclasses.dataclass(frozen=True)
class CLAPConfig:
    version: str = "2023"  # "2022" | "2023"
    sample_rate: int = 44100
    n_fft: int = 1024
    hop: int = 320
    mel_bins: int = 64
    fmin: float = 50.0
    d_proj: int = 1024
    classes_num: int = 527
    proj_dropout: float = 0.5  # the projection's dropout in train mode

    @property
    def fmax(self) -> float:
        return 8000.0 if self.version == "2023" else 14000.0

    @property
    def duration(self) -> float:
        return 7.0 if self.version == "2023" else 5.0

    @property
    def d_in(self) -> int:
        return 768 if self.version == "2023" else 2048

    @property
    def n_samples(self) -> int:
        """A clip's samples, rounded up to whole hops (the JAX extractor's n)."""
        n = int(self.duration * self.sample_rate)
        return (n + self.hop - 1) // self.hop * self.hop


class Projection(nn.Module):
    def __init__(self, d_in: int, d_out: int = 1024):
        super().__init__()
        self.linear1 = nn.Linear(d_in, d_out, bias=False)
        self.linear2 = nn.Linear(d_out, d_out, bias=False)
        # eps 1e-6: flax's LayerNorm default, which the JAX package uses
        # (models/clap.py:63 and :131); msclap's torch module has 1e-5
        self.layer_norm = nn.LayerNorm(d_out, eps=1e-6)

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None,
                p: float = 0.0) -> torch.Tensor:
        """p > 0: train mode, flax dropout of the second branch drawn from gen."""
        from .htsat_train_fused import _dropout

        e1 = self.linear1(x)
        return self.layer_norm(e1 + _dropout(gen, self.linear2(F.gelu(e1)), p))


class HTSATWrapper(nn.Module):
    """msclap's 2023 base: the HTS-AT under base.htsat."""

    def __init__(self, config: HTSATConfig):
        super().__init__()
        self.htsat = HTSAT(config)


class CLAPAudioEncoder(nn.Module):
    """waveform (B, N) at 44.1 kHz + lengths -> projected embedding (B, 1024)
    (and the backbone embedding with return_backbone=True), strict float32."""

    def __init__(self, config: CLAPConfig = CLAPConfig()):
        super().__init__()
        self.config = config
        if config.version == "2022":
            self.base = Cnn14(config.classes_num, config.mel_bins)
            d_in = config.d_in
        else:
            self.base = HTSATWrapper(HTSATConfig(mel_bins=config.mel_bins,
                                                  num_classes=config.classes_num))
            d_in = self.base.htsat.config.num_features  # 768, as flax infers it
        self.projection = Projection(d_in, config.d_proj)

    def logmel(self, wav: torch.Tensor, lengths: torch.Tensor):
        cfg = self.config
        return logmel_frontend_general(wav, lengths, cfg.sample_rate, cfg.mel_bins, cfg.fmin,
                                       cfg.fmax, cfg.n_fft, cfg.hop)

    def encode_train(self, wav: torch.Tensor, lengths: torch.Tensor,
                     gen: Optional[torch.Generator], mesh=None):
        """The train-mode forward of fine-tuning (CLAPAudioEncoder with
        train=True), float32 and differentiable: the Cnn14's BatchNorms or the
        HTS-AT's bn0 on the batch statistics (the global batch's with a
        data-parallel mesh), the HTS-AT's DropPath and the projection's
        dropout drawn from gen. -> (projected (B, d_proj), the new running
        statistics as a models/bn.py dict)."""
        from . import bn as bn_mod
        from .htsat_train_fused import htsat_encode_train

        logmel, nf = self.logmel(wav, lengths)
        stats = bn_mod.new_stats(mesh)
        if self.config.version == "2022":
            emb = self.base.forward_train(logmel, nf, stats)["embedding"]
        else:
            enc = self.base.htsat
            emb, new = htsat_encode_train(enc, logmel, gen,
                                          (enc.bn0.running_mean, enc.bn0.running_var), nf,
                                          torch.float32, impl="autograd", mesh=mesh)
            stats[enc.bn0] = new
        return self.projection(emb, gen, self.config.proj_dropout), stats

    @torch.no_grad()
    def forward(self, wav: torch.Tensor, lengths: torch.Tensor, return_backbone: bool = False):
        logmel, nf = self.logmel(wav, lengths)
        if self.config.version == "2022":
            emb = self.base(logmel, nf)["embedding"]
        else:
            emb = self.base.htsat(logmel, nf, torch.float32, False, "plain")
        proj = self.projection(emb)
        return (proj, emb) if return_backbone else proj


def init_weights(model: CLAPAudioEncoder, generator: torch.Generator) -> CLAPAudioEncoder:
    """Seeded random weights, drawn only from `generator`
    (models/htsat.py::init_weights: lecun-normal matmul and conv weights,
    zero biases, unit norms, truncated-normal(0.02) bias tables)."""
    htsat_mod.init_weights(model, generator)
    return model


@torch.no_grad()
def clap_audio_forward_fused(
    model: CLAPAudioEncoder,
    wav: torch.Tensor,
    lengths: torch.Tensor,
    mm_dtype: torch.dtype = torch.bfloat16,
    fast_softmax: bool = False,
    impl: str = "kernel",
) -> torch.Tensor:
    """CLAP-2023 projected audio embedding (B, 1024) with the HTS-AT tower
    on models/htsat_fused.py::htsat_apply_fused: the swin kernels on a card
    with mm_dtype bfloat16 (impl="plain": their plain versions). The
    frontend and the projection stay float32."""
    if model.config.version != "2023":
        raise ValueError("the fused path covers the HTS-AT (2023) tower")
    from .htsat_fused import htsat_apply_fused

    logmel, nf = model.logmel(wav, lengths)
    emb = htsat_apply_fused(model.base.htsat, logmel, nf, mm_dtype, fast_softmax, impl)
    return model.projection(emb.to(torch.float32))


def load_clap_clip(path: str, duration: float, sr: int = 44100,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """The reference clip policy: tile short clips, random-crop long ones
    (the crop start drawn from rng, only for clips longer than the window)."""
    from ..utils.audio_io import load_wav

    y, _ = load_wav(path, sr=sr)
    n = int(duration * sr)
    if n >= len(y):
        reps = int(np.ceil(n / max(len(y), 1)))
        y = np.tile(y, reps)[:n]
    else:
        rng = rng or np.random.default_rng(0)
        start = int(rng.integers(0, len(y) - n))
        y = y[start: start + n]
    return y.astype(np.float32)


@torch.no_grad()
def extract_clap_feature(
    paths: Sequence[str],
    version: str = "2022",
    model: Optional[CLAPAudioEncoder] = None,
    batch_size: int = 16,
    seed: int = 0,
    random_init: bool = False,
    ckpt_path: Optional[str] = None,
    device="cuda",
    compute_dtype: Optional[torch.dtype] = None,
    impl: str = "kernel",
) -> np.ndarray:
    """The projected CLAP embedding of each file, (N, 1024) float32
    (extract_feature.py:78-102; the JAX extract_clap_feature's policy).

    One np.random.default_rng(seed) crops the files in order; batches of
    batch_size are filled with copies of their first clip and cut back after
    the forward; lengths is the stacked width. model: a CLAPAudioEncoder
    with weights, else the registry's (seed-0 random weights with
    random_init, or an msclap state_dict at ckpt_path). compute_dtype
    torch.bfloat16 runs the 2023 tower's fused flow (the swin kernels, fast
    softmax, as the JAX extractor on its accelerator), torch.float32 the
    strict graph (TF32 off); None picks bf16 for 2023 on a card and float32
    otherwise. impl "plain" runs the bf16 flow on the kernels' plain
    versions. device "cuda" without a card raises."""
    from ..utils.precision import strict_f32

    cfg = CLAPConfig(version=version)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("extract_clap_feature(device='cuda'): no CUDA card available")
    if model is None:
        from ..extract.registry import initialize_pretrained_model

        model = initialize_pretrained_model("clap2023" if version == "2023" else "clap",
                                            ckpt_path=ckpt_path, random_init=random_init)
    model = model.to(device).eval()
    if compute_dtype is None:
        fused = device.type == "cuda" and version == "2023"
        compute_dtype = torch.bfloat16 if fused else torch.float32
    n = cfg.n_samples
    rng = np.random.default_rng(seed)
    paths = list(paths)
    out = []
    with strict_f32():
        for lo in range(0, len(paths), batch_size):
            clips = [load_clap_clip(p, cfg.duration, cfg.sample_rate, rng)
                     for p in paths[lo: lo + batch_size]]
            k = len(clips)
            clips += [clips[0]] * (batch_size - k)
            wav = torch.from_numpy(np.stack(clips)[:, :n]).to(device)
            lengths = torch.full((batch_size,), wav.shape[1], dtype=torch.int32, device=device)
            if compute_dtype == torch.bfloat16:
                f = clap_audio_forward_fused(model, wav, lengths, torch.bfloat16,
                                             fast_softmax=True, impl=impl)
            else:
                f = model(wav, lengths)
            out.append(f[:k].float().cpu().numpy())
    return np.concatenate(out, 0) if out else np.zeros((0, cfg.d_proj), np.float32)
