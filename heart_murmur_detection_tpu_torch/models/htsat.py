"""HTS-AT (the OPERA-CT encoder) as a torch module — counterpart of
heart_murmur_detection_tpu/models/htsat.py.

Parameters live under the reference's state_dict key names (bn0,
patch_embed.proj, patch_embed.norm, layers.{i}.blocks.{b}.{norm1, attn.qkv,
attn.proj, attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2},
layers.{i}.downsample.{norm, reduction}, norm), so a reference checkpoint
loads without renaming. The eval forward is
models.htsat_fused.htsat_apply_fused, routed through the swin kernels of
ops/swin.py; the training forward is models.htsat_train_fused
.htsat_encode_train, routed through ops/swin_train.py.

The tscam head (enable_tscam, the JAX default) is `tscam_conv`, the
reference's (c_freq_bin, 3) conv from the final 8x8 map to num_classes
logits: htsat_apply_fused(..., tscam=True) adds framewise_output,
clipwise_output and clipwise_logits to latent_output, and
htsat_forward_long averages every output over sliding crops of a long clip.
No loss of the port reads the head, so its weight and bias are buffers,
not parameters: a training step leaves them where they are, as the JAX
package's zero-gradient Adam update does. The fine-tuning classifier
(train/finetune.py) holds them as parameters instead (TscamConv's
trainable), because its L2 term reads every encoder weight. A state without the head (a
checkpoint written before it was carried, a JAX tree with enable_tscam
off) keeps the head as built, as the JAX registry merges a checkpoint into
its initial tree. A geometry whose final map has fewer frequency rows than
freq_ratio (c_freq_bin 0, the narrow test configs) has no head.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

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
    drop_path_rate: float = 0.1  # DropPath rates linspace(0, rate, sum(depths)) over the blocks
    mel_bins: int = 64
    num_classes: int = 527  # the tscam head's logits
    enable_tscam: bool = True

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.mel_bins  # 4

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))  # 768

    @property
    def final_side(self) -> int:
        """SF = ST: the side of the final token map (8)."""
        return self.spec_size // 2 ** (len(self.depths) - 1) // self.patch_stride[0]

    @property
    def c_freq_bin(self) -> int:
        """Frequency rows of the final map a time group (2): the tscam
        conv's kernel height."""
        return self.final_side // self.freq_ratio


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


class TscamConv(nn.Module):
    """The tscam head's conv (htsat.py:678-683): num_features -> num_classes
    over a (c_freq_bin, 3) kernel, padding (0, 1); weight and bias under the
    reference's names, held as buffers (see the module doc), or as
    parameters with trainable=True (the fine-tuning classifier's, whose L2
    term reads them)."""

    def __init__(self, dim: int, classes: int, kh: int, trainable: bool = False):
        super().__init__()
        weight, bias = torch.zeros(classes, dim, kh, 3), torch.zeros(classes)
        if trainable:
            self.weight, self.bias = nn.Parameter(weight), nn.Parameter(bias)
        else:
            self.register_buffer("weight", weight)
            self.register_buffer("bias", bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..utils.precision import strict_f32

        with strict_f32():
            return F.conv2d(x, self.weight, self.bias, padding=(0, 1))

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict,
                              missing_keys, unexpected_keys, error_msgs):
        n = len(missing_keys)
        super()._load_from_state_dict(state_dict, prefix, local_metadata, strict,
                                      missing_keys, unexpected_keys, error_msgs)
        if not any(k.startswith(prefix) for k in state_dict):  # a state without the head
            del missing_keys[n:]


@dataclasses.dataclass(frozen=True)
class PreparedStage:
    """One stage's blocks laid out for the kernels, plus its shift mask."""

    blocks: Tuple[SwinBlockParams, ...]
    window: int
    shift: int
    mask: Optional[torch.Tensor]  # (nW, N, N) f32 for the shifted blocks


@dataclasses.dataclass(frozen=True)
class TrainStage:
    """One stage's constants for the training forward on one device: the
    relative-position index and its segments (ops.swin_train.rel_pos_bias)
    and the shift mask."""

    window: int
    shift: int
    idx: torch.Tensor  # (N*N,) long
    seg: torch.Tensor  # (T, K) long
    mask: Optional[torch.Tensor]  # (nW, N, N) f32 for the shifted blocks


class HTSAT(nn.Module):
    """HTS-AT encoder: mel (B, T, F) [+ frame counts] -> latent (B, 768)."""

    def __init__(self, config: HTSATConfig = HTSATConfig()):
        super().__init__()
        cfg = self.config = config
        self.bn0 = nn.BatchNorm2d(cfg.mel_bins, eps=1e-5)
        self.patch_embed = PatchEmbed(
            cfg.embed_dim, cfg.patch_size, cfg.patch_stride, cfg.in_chans
        )
        self.layers = nn.ModuleList(BasicLayer(cfg, i) for i in range(len(cfg.depths)))
        self.norm = nn.LayerNorm(cfg.num_features, eps=1e-5)
        self.tscam_conv = None
        if cfg.enable_tscam and cfg.c_freq_bin:
            self.tscam_conv = TscamConv(cfg.num_features, cfg.num_classes, cfg.c_freq_bin)
        self._prepared = {}
        self._train_stages = {}

    def train_stages(self, device) -> Tuple[TrainStage, ...]:
        """Per-stage TrainStage on `device`, built at first use and cached
        (they depend on the config only)."""
        from ..ops.swin_train import bias_segments

        key = torch.device(device)
        if key not in self._train_stages:
            stages = []
            for i in range(len(self.config.depths)):
                H, W, window, shift = stage_geometry(self.config, i)
                idx = _relative_position_index(window, window).reshape(-1)
                mask = None
                if shift:
                    mask = torch.as_tensor(_shift_attn_mask(H, W, window, shift), device=key)
                stages.append(TrainStage(
                    window, shift, torch.as_tensor(idx, device=key),
                    bias_segments(idx).to(key), mask,
                ))
            self._train_stages[key] = tuple(stages)
        return self._train_stages[key]

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
        tscam: bool = False,
    ):
        from .htsat_fused import htsat_apply_fused

        return htsat_apply_fused(self, mel, n_frames, mm_dtype, fast_softmax, impl, tscam)


def tscam_outputs(model: HTSAT, x: torch.Tensor) -> dict:
    """The tscam head on the final LayerNorm's tokens x (B, SF * ST, C),
    float32 (the JAX HTSAT :379-398): the SF x ST map unfolded so each
    c_freq_bin rows of a time group sit on one row, the (c_freq_bin, 3)
    conv, its logits (B, 4 ST, classes) -> framewise_output (their sigmoid
    repeated 8 * patch_stride[1] times along time), clipwise_logits (their
    time mean) and clipwise_output (its sigmoid)."""
    cfg = model.config
    if model.tscam_conv is None:
        raise ValueError("this HTS-AT has no tscam head (enable_tscam off, or c_freq_bin 0)")
    B, _, C = x.shape
    SF = ST = cfg.final_side
    c = cfg.c_freq_bin
    fmap = x.to(torch.float32).reshape(B, SF // c, c, ST, C).permute(0, 2, 1, 3, 4)
    fmap = fmap.reshape(B, c, -1, C).permute(0, 3, 1, 2)  # NCHW (B, C, c, 4 ST)
    logits = model.tscam_conv(fmap).reshape(B, cfg.num_classes, -1).transpose(1, 2)
    clip = logits.mean(dim=1)
    return {
        "framewise_output": torch.sigmoid(logits).repeat_interleave(
            8 * cfg.patch_stride[1], dim=1),
        "clipwise_output": torch.sigmoid(clip),
        "clipwise_logits": clip,
    }


def htsat_forward_long(
    model: HTSAT,
    mel: torch.Tensor,
    crop_size: int = 1024,
    overlap: int = 512,
    batch_size: int = 16,
    mm_dtype: torch.dtype = torch.float32,
    fast_softmax: bool = False,
    impl: str = "kernel",
) -> dict:
    """Sliding-window inference for clips longer than a crop (the JAX
    htsat_forward_long :281-305, htsat.py:939-979): crops of crop_size
    frames starting at arange(0, T - crop_size - 1, overlap), each output
    averaged over the crops; with no start, one plain forward. The crops of
    all clips are stacked on the batch axis, crop-major, and run through
    htsat_apply_fused batch_size rows at a time (bn0 is on its running
    statistics, so rows are independent). mel (B, T, F) -> {"latent_output"
    [, the tscam outputs, where the model has the head]}."""
    from .htsat_fused import htsat_apply_fused

    tscam = model.tscam_conv is not None
    B, T, _ = mel.shape

    def run(x: torch.Tensor) -> dict:
        out = htsat_apply_fused(model, x, None, mm_dtype, fast_softmax, impl, tscam)
        return out if tscam else {"latent_output": out}

    starts = np.arange(0, T - crop_size - 1, overlap)
    if len(starts) == 0:
        return run(mel)
    crops = torch.cat([mel[:, s : s + crop_size] for s in starts])  # (n B, crop, F)
    parts = [run(crops[lo : lo + batch_size]) for lo in range(0, crops.shape[0], batch_size)]
    return {k: torch.cat([p[k] for p in parts]).reshape(len(starts), B, *parts[0][k].shape[1:])
            .mean(dim=0) for k in parts[0]}


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
            if isinstance(m, TscamConv):
                continue  # drawn last, so the other weights' draws are as without the head
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
        for m in module.modules():
            if isinstance(m, TscamConv):
                trunc_normal_(m.weight, 1.0 / math.sqrt(m.weight[0].numel()))
                m.bias.zero_()
