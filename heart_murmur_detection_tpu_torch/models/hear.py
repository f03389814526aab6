"""HeAR (health acoustic representations) encoder — counterpart of
heart_murmur_detection_tpu/models/hear.py: a ViT-L/16 over the (192, 128)
mel-PCEN of a 2-s clip at 16 kHz (the reference's finetuning.py:1081-1104
ViTConfig: hidden 1024, 24 layers, 16 heads, MLP 4096, a linear pooler
1024 -> 512; extract_feature.py:174-210 serves the 512-d pooled embedding).

HF-ViT conventions: learned position embeddings over cls + 96 patches,
pre-norm blocks (LN eps 1e-6), CLS-token pooling through a linear pooler.
Module keys: patch_embed.proj, cls_token, pos_embed, blocks.{i}.norm1 /
attn.qkv / attn.proj / norm2 / mlp.fc1 / mlp.fc2, norm, pooler
(extract/convert.py maps the JAX variables and the HF `google/hear-pytorch`
names onto them).

`forward` is the strict float32 flax semantics (the tests' reference);
`extract_hear_feature` runs models/vit_fused.py::hear_forward_fused, whose
24 blocks are the CUDA kernels of ops/vit.py on a card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..audio.hear_frontend import N_SAMPLES, hear_preprocess
from . import vit_mae
from .vit_mae import PatchEmbed, PreparedBlocks, ViTBlock


@dataclasses.dataclass(frozen=True)
class HeARConfig:
    image_size: tuple = (192, 128)
    patch_size: int = 16
    hidden: int = 1024
    depth: int = 24
    heads: int = 16
    mlp_ratio: float = 4.0
    pooled_dim: int = 512

    @property
    def num_patches(self) -> int:
        return (self.image_size[0] // self.patch_size) * (self.image_size[1] // self.patch_size)


class HeAREncoder(PreparedBlocks):
    """waveform (B, <= 32000) -> dict(pooled (B, 512), cls (B, 1024), tokens
    (B, 96, 1024)), or from a (B, 192, 128) spectrogram."""

    def __init__(self, config: HeARConfig = HeARConfig()):
        super().__init__()
        cfg = self.config = config
        D = cfg.hidden
        self.patch_embed = PatchEmbed(cfg.patch_size, D)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, D))
        self.blocks = nn.ModuleList(ViTBlock(D, cfg.heads, cfg.mlp_ratio)
                                    for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(D, eps=1e-6)
        self.pooler = nn.Linear(D, cfg.pooled_dim)

    def forward(self, audio: torch.Tensor, from_spectrogram: bool = False) -> dict:
        x = audio.to(torch.float32) if from_spectrogram else hear_preprocess(audio)
        h = self.patch_embed.proj(x[:, None]).flatten(2).transpose(1, 2)
        cls = self.cls_token.expand(h.shape[0], -1, -1)
        h = torch.cat([cls, h], dim=1) + self.pos_embed
        for blk in self.blocks:
            h = blk(h)
        h = self.norm(h)
        return {"pooled": self.pooler(h[:, 0]), "cls": h[:, 0], "tokens": h[:, 1:]}


def init_weights(model: HeAREncoder, generator: torch.Generator) -> None:
    """Seeded random init, drawn only from `generator`: the MAE encoders'
    (lecun-normal matmul and conv weights, zero biases, unit norms,
    normal(0.02) cls token), and normal(0.02) position embeddings, as flax
    initialises them."""
    vit_mae.init_weights(model, generator)
    with torch.no_grad():
        model.pos_embed.copy_(torch.empty(model.pos_embed.shape).normal_(generator=generator) * 0.02)
    model.invalidate_prepared()


def load_clip(path: str) -> np.ndarray:
    """One clip by the extraction policy: decoded at 16 kHz, trimmed or
    zero-padded to 2 s (32000 samples), float32."""
    from ..utils.audio_io import load_wav

    y, _ = load_wav(path, sr=16000)
    return y[:N_SAMPLES] if len(y) > N_SAMPLES else np.pad(y, (0, N_SAMPLES - len(y)))


@torch.no_grad()
def extract_hear_feature(
    paths: Sequence[str],
    model: Optional[HeAREncoder] = None,
    random_init: bool = False,
    ckpt_path: Optional[str] = None,
    batch_size: int = 16,
    device="cuda",
    compute_dtype: Optional[torch.dtype] = None,
    impl: str = "kernel",
) -> np.ndarray:
    """The 512-d pooled embedding of each file, (N, pooled_dim) float32
    (extract_feature.py:174-210; the JAX extract_hear_feature's policy).

    Each file is loaded by `load_clip`; batches of `batch_size` are filled
    with copies of their first clip and cut back after the forward, so every
    batch has one shape. input_sec plays no part: a clip is always 2 s.
    model: a HeAREncoder with weights, else the registry's: drawn from
    seed 0 (random_init) or loaded from a google/hear-pytorch state_dict at
    ckpt_path (extract/convert.py::load_hear_ckpt); without either,
    FileNotFoundError.
    compute_dtype: torch.bfloat16 is the extraction flow (the 24 blocks on
    the kernels of ops/vit.py on a card, fast softmax, as the JAX fused
    path), torch.float32 the strict path (plain versions, TF32 off). None
    picks bf16 on a card and float32 on the CPU, as the JAX extractor runs
    its fused path on its accelerator and the flax graph elsewhere. impl
    "plain" runs the bf16 flow on the kernels' plain versions (the on-card
    reference). device "cuda" without a card raises."""
    from ..utils.precision import strict_f32
    from .vit_fused import hear_forward_fused

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("extract_hear_feature(device='cuda'): no CUDA card available")
    if model is None:
        from ..extract.registry import initialize_pretrained_model

        model = initialize_pretrained_model("hear", ckpt_path=ckpt_path,
                                            random_init=random_init)
    model = model.to(device).eval()
    if compute_dtype is None:
        compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    paths = list(paths)
    out = []
    with strict_f32():
        for lo in range(0, len(paths), batch_size):
            clips = [load_clip(p) for p in paths[lo:lo + batch_size]]
            k = len(clips)
            clips += [clips[0]] * (batch_size - k)
            wav = torch.from_numpy(np.stack(clips)).to(device)
            f = hear_forward_fused(model, wav, mm_dtype=compute_dtype,
                                   fast_softmax=compute_dtype == torch.bfloat16, impl=impl)
            out.append(f[:k].float().cpu().numpy())
    return np.concatenate(out, 0) if out else np.zeros((0, model.config.pooled_dim), np.float32)
