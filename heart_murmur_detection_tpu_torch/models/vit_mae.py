"""The masked-autoencoder ViT encoders, eval only — counterpart of
heart_murmur_detection_tpu/models/vit_mae.py: OPERA-GT (ViT-S, patch 4, img
256x64) and Audio-MAE (ViT-B/16, img 1024x128).

Modules keep the reference torch key names (patch_embed.proj, cls_token,
blocks.{i}.norm1 / attn.qkv / attn.proj / norm2 / mlp.fc1 / mlp.fc2, norm,
fc_norm), so reference checkpoints load by name
(extract/convert.py::load_mae_ckpt). The fixed 2-D sin-cos position
embedding is built from the config (the reference's transposed patch_hw
grid) and is not a weight. The decoder and the random masking of MAE
pretraining are not here.

`forward` / `forward_feature` are the strict float32 flax semantics (the
tests' reference); the extraction path runs the same weights through
models/vit_fused.py, whose blocks are the kernels of ops/vit.py.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.vit import prep_vit_block
from . import htsat


def _sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2))
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_pos_embed_flexible(dim: int, grid_size: Tuple[int, int], cls_token: bool):
    """Fixed 2-D sin-cos embedding over grid_size = (gh, gw), w first, as
    the reference (mae_utils/pos_embed.py:38-55); a zero row for cls."""
    gh = np.arange(grid_size[0], dtype=np.float64)
    gw = np.arange(grid_size[1], dtype=np.float64)
    grid = np.stack(np.meshgrid(gw, gh), axis=0)  # w first, as reference
    emb = np.concatenate(
        [_sincos_1d(dim // 2, grid[0]), _sincos_1d(dim // 2, grid[1])], axis=1
    )
    if cls_token:
        emb = np.concatenate([np.zeros((1, dim)), emb], axis=0)
    return emb.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MAEConfig:
    """The encoder fields of the JAX MAEConfig (the decoder's are not used)."""

    img_size: Tuple[int, int] = (256, 64)
    patch_size: int = 4
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.img_size[0] // self.patch_size, self.img_size[1] // self.patch_size)

    @property
    def num_patches(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def patch_hw(self) -> Tuple[int, int]:
        # reference convention: (W//p, H//p) — the pos-embed grid is transposed
        return (self.grid[1], self.grid[0])


def mae_vit_small_config(**kw) -> MAEConfig:
    """OPERA-GT (model_util.py:190-211)."""
    return MAEConfig(**kw)


def audiomae_base_config(**kw) -> MAEConfig:
    """Audio-MAE ViT-B (mae_training.py:282-309, extract_feature.py:130-137)."""
    base = dict(img_size=(1024, 128), patch_size=16, embed_dim=768, depth=12, num_heads=12)
    base.update(kw)
    return MAEConfig(**base)


class Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class ViTBlock(nn.Module):
    """Pre-norm timm block (LN eps 1e-6), eval."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, eps: float = 1e-6):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        nh, hd = self.num_heads, C // self.num_heads
        qkv = self.attn.qkv(self.norm1(x)).reshape(B, N, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        a = torch.softmax((q * hd**-0.5) @ k.transpose(-1, -2), -1)
        h = (a @ v).permute(0, 2, 1, 3).reshape(B, N, C)
        x = x + self.attn.proj(h)
        h = self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x)), approximate="none"))
        return x + h


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(1, dim, patch, stride=patch)


class _MAEEncoder(nn.Module):
    """Patch conv, cls token and the ViT blocks; `prepared` caches the
    blocks laid out for ops/vit.py (dropped on load_state_dict and moves)."""

    def __init__(self, cfg: MAEConfig):
        super().__init__()
        self.config = cfg
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        self.blocks = nn.ModuleList(
            ViTBlock(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio) for _ in range(cfg.depth)
        )
        pos = sincos_pos_embed_flexible(cfg.embed_dim, cfg.patch_hw, cls_token=True)
        self.register_buffer("pos_embed", torch.from_numpy(pos)[None], persistent=False)
        self._prepared = {}

    def prepared(self, mm_dtype: torch.dtype):
        dev = self.cls_token.device
        key = (mm_dtype, dev)
        if key not in self._prepared:
            # plain tensors, usable in and out of inference mode
            with torch.inference_mode(False), torch.no_grad():
                self._prepared[key] = tuple(
                    prep_vit_block(blk.state_dict(), blk.num_heads, mm_dtype, dev)
                    for blk in self.blocks
                )
        return self._prepared[key]

    def invalidate_prepared(self) -> None:
        self._prepared = {}

    def _apply(self, fn, *args, **kwargs):
        self.invalidate_prepared()
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self.invalidate_prepared()
        return super()._load_from_state_dict(*args, **kwargs)

    def _tokens(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W) -> cls + patch tokens (B, 1 + L, D) with positions, f32."""
        h = self.patch_embed.proj(x[:, None].to(torch.float32)).flatten(2).transpose(1, 2)
        h = h + self.pos_embed[:, 1 : h.shape[1] + 1]
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(h.shape[0], -1, -1)
        h = torch.cat([cls, h], dim=1)
        for blk in self.blocks:
            h = blk(h)
        return h


class MaskedAutoencoderViT(_MAEEncoder):
    """OPERA-GT's encoder with its final LayerNorm `norm`."""

    def __init__(self, cfg: MAEConfig = MAEConfig()):
        super().__init__(cfg)
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=1e-6)

    def forward_feature(self, x: torch.Tensor) -> torch.Tensor:
        """LP feature: mean tokens (no cls) then the final LN
        (models_mae.py:1032-1050). x (B, 256, 64) -> (B, 384)."""
        return self.norm(self._tokens(x)[:, 1:].mean(1))

    forward = forward_feature


class AudioMAEClassifierBackbone(_MAEEncoder):
    """Audio-MAE's extract backbone (VisionTransformer global_pool,
    models_mae.py:1173-1224): zero-pad the fbank to img_size, encode, mean
    tokens (no cls), fc_norm."""

    def __init__(self, cfg: MAEConfig = None):
        super().__init__(cfg or audiomae_base_config())
        self.fc_norm = nn.LayerNorm(self.config.embed_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, Fb = x.shape
        H, W = self.config.img_size
        x = F.pad(x, (0, W - Fb, 0, H - T))
        return self.fc_norm(self._tokens(x)[:, 1:].mean(1))


def init_weights(module: _MAEEncoder, generator: torch.Generator) -> None:
    """Seeded random init, drawn only from `generator`: the HTS-AT init for
    the matmul, conv and norm weights (lecun-normal, zero biases, unit
    norms), and normal(0.02) for the cls token, as flax initialises it."""
    htsat.init_weights(module, generator)
    with torch.no_grad():
        module.cls_token.copy_(torch.empty(module.cls_token.shape).normal_(generator=generator) * 0.02)
    module.invalidate_prepared()
