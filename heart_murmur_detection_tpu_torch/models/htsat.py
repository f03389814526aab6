"""HTS-AT (the OPERA-CT encoder) as a torch module, eval only — counterpart
of heart_murmur_detection_tpu/models/htsat.py.

Parameters live under the reference's state_dict key names (bn0,
patch_embed.proj, patch_embed.norm, layers.{i}.blocks.{b}.{norm1, attn.qkv,
attn.proj, attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2},
layers.{i}.downsample.{norm, reduction}, norm), so a reference checkpoint
loads without renaming. The forward is models.htsat_fused.htsat_apply_fused:
there is one forward, routed through the swin kernels of ops/swin.py.
The tscam head (clipwise/framewise outputs) is not carried.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.swin import SwinBlockParams, prep_block


@dataclasses.dataclass(frozen=True)
class HTSATConfig:
    spec_size: int = 256
    patch_size: int = 4
    patch_stride: Tuple[int, int] = (4, 4)
    in_chans: int = 1
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    mel_bins: int = 64

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.mel_bins  # 4

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))  # 768


def _relative_position_index(wh: int, ww: int) -> np.ndarray:
    """Static (wh*ww, wh*ww) index into the (2wh-1)(2ww-1) bias table."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def _shift_attn_mask(H: int, W: int, window: int, shift: int) -> np.ndarray:
    """Static additive mask (nW, win^2, win^2) for shifted windows (0 / -100)."""
    img = np.zeros((H, W))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = (
        img.reshape(H // window, window, W // window, window)
        .transpose(0, 2, 1, 3)
        .reshape(-1, window * window)
    )
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def stage_geometry(cfg: HTSATConfig, i_layer: int) -> Tuple[int, int, int, int]:
    """(H, W, window, shift of the odd blocks) of stage i_layer; a map no
    larger than the window runs one unshifted window (htsat.py SwinBlock)."""
    H = cfg.spec_size // cfg.patch_stride[0] // 2**i_layer
    W = cfg.spec_size // cfg.patch_stride[1] // 2**i_layer
    if min(H, W) > cfg.window_size:
        return H, W, cfg.window_size, cfg.window_size // 2
    return H, W, min(H, W), 0


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, heads: int, qkv_bias: bool = True):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads)
        )


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, mlp_ratio: float, qkv_bias: bool):
        super().__init__()
        self.heads, self.window = heads, window
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window, heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def rel_pos_bias(self) -> torch.Tensor:
        """table[rel_idx] -> (heads, N, N), gathered once at weight load."""
        N = self.window * self.window
        idx = torch.as_tensor(
            _relative_position_index(self.window, self.window).reshape(-1),
            device=self.attn.relative_position_bias_table.device,
        )
        table = self.attn.relative_position_bias_table
        return table[idx].reshape(N, N, self.heads).permute(2, 0, 1)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int, patch_size: int, patch_stride: Tuple[int, int], in_chans: int):
        super().__init__()
        if tuple(patch_stride) != (patch_size, patch_size):
            raise NotImplementedError("only non-overlapping patches (stride == patch size)")
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_stride)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)


class BasicLayer(nn.Module):
    def __init__(self, cfg: HTSATConfig, i_layer: int):
        super().__init__()
        dim = int(cfg.embed_dim * 2**i_layer)
        _, _, window, _ = stage_geometry(cfg, i_layer)
        self.blocks = nn.ModuleList(
            SwinBlock(dim, cfg.num_heads[i_layer], window, cfg.mlp_ratio, cfg.qkv_bias)
            for _ in range(cfg.depths[i_layer])
        )
        if i_layer < len(cfg.depths) - 1:
            self.downsample = PatchMerging(dim)


@dataclasses.dataclass(frozen=True)
class PreparedStage:
    """One stage's blocks laid out for the kernels, plus its shift mask."""

    blocks: Tuple[SwinBlockParams, ...]
    window: int
    shift: int
    mask: Optional[torch.Tensor]  # (nW, N, N) f32 for the shifted blocks


class HTSAT(nn.Module):
    """Eval HTS-AT encoder: mel (B, T, F) [+ frame counts] -> latent (B, 768)."""

    def __init__(self, config: HTSATConfig = HTSATConfig()):
        super().__init__()
        cfg = self.config = config
        self.bn0 = nn.BatchNorm2d(cfg.mel_bins, eps=1e-5)
        self.patch_embed = PatchEmbed(
            cfg.embed_dim, cfg.patch_size, cfg.patch_stride, cfg.in_chans
        )
        self.layers = nn.ModuleList(BasicLayer(cfg, i) for i in range(len(cfg.depths)))
        self.norm = nn.LayerNorm(cfg.num_features, eps=1e-5)
        self._prepared = {}

    # -- weights laid out for the kernels, once per (dtype, device) ------------
    def prepared(self, mm_dtype: torch.dtype) -> Tuple[PreparedStage, ...]:
        """Per-stage SwinBlockParams (padded, re-laid-out, gathered bias) and
        shift masks, built at first use and cached. The cache is dropped by
        load_state_dict and by moves (.to / .cuda / .float); call
        invalidate_prepared() after editing parameters in place."""
        dev = self.norm.weight.device
        key = (mm_dtype, dev)
        if key not in self._prepared:
            stages = []
            for i, layer in enumerate(self.layers):
                H, W, window, shift = stage_geometry(self.config, i)
                mask = None
                if shift:
                    mask = torch.as_tensor(_shift_attn_mask(H, W, window, shift), device=dev)
                blocks = tuple(
                    prep_block(blk.state_dict(), blk.heads, blk.rel_pos_bias(), mm_dtype, dev)
                    for blk in layer.blocks
                )
                stages.append(PreparedStage(blocks, window, shift, mask))
            self._prepared[key] = tuple(stages)
        return self._prepared[key]

    def invalidate_prepared(self) -> None:
        self._prepared = {}

    def _apply(self, fn, *args, **kwargs):
        self.invalidate_prepared()
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        # runs for this module whenever it or a module holding it loads
        self.invalidate_prepared()
        return super()._load_from_state_dict(*args, **kwargs)

    def forward(
        self,
        mel: torch.Tensor,
        n_frames: Optional[torch.Tensor] = None,
        mm_dtype: torch.dtype = torch.float32,
        fast_softmax: bool = False,
        impl: str = "kernel",
    ) -> torch.Tensor:
        from .htsat_fused import htsat_apply_fused

        return htsat_apply_fused(self, mel, n_frames, mm_dtype, fast_softmax, impl)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init in the flax defaults' spirit (lecun-normal matmul
    and conv weights, zero biases, unit norms, truncated-normal(0.02) bias
    tables), drawn only from `generator`."""

    def trunc_normal_(t: torch.Tensor, std: float):
        # N(0, 1) truncated to [-2, 2] by redrawing, scaled to std
        w = torch.empty(t.shape).normal_(generator=generator)
        while True:
            bad = w.abs() > 2.0
            if not bad.any():
                break
            w[bad] = torch.empty(int(bad.sum())).normal_(generator=generator)
        t.copy_(w * (std / 0.87962566103423978))

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                trunc_normal_(m.weight, 1.0 / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm2d):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
            elif isinstance(m, WindowAttention):
                trunc_normal_(m.relative_position_bias_table, 0.02)
