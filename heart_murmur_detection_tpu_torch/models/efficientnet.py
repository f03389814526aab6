"""EfficientNet-B0, the OPERA-CE encoder — counterpart of
heart_murmur_detection_tpu/models/efficientnet.py (`MBConv` :67,
`EfficientNet` :126, `ColaEfficientNetEncoder` :180; the reference's
models_cola.py:42-59, efficientnet-pytorch 0.7.1's
`EfficientNet.from_name('efficientnet-b0', include_top=False)` behind a
1 -> 3 channel 3x3 VALID convolution).

Layout (B, C, T, F): the mel (B, T, F) enters as (B, 1, T, F), time on the
height axis, as the flax NHWC input (B, T, F, 1) has it. Module names are
efficientnet-pytorch's (cnn1, efficientnet._conv_stem, _bn0,
_blocks.{i}._expand_conv / _bn0 / _depthwise_conv / _bn1 / _se_reduce /
_se_expand / _project_conv / _bn2, _conv_head, _bn1), so a reference
Cola(efficientnet) state_dict loads by name
(extract/convert.py::load_cola_efficientnet_ckpt).

- TF "SAME" padding: a stride-2 convolution pads the odd extra row and
  column at the end (the flax / TF rule), which nn.Conv2d's padding="same"
  cannot express, so it is padded explicitly;
- BatchNorm: eps 1e-3, flax momentum 0.99, through models/bn.py (eval on the
  running statistics; train mode with the fast variance and the biased
  running update, the new statistics into the caller's dict);
- compute dtype: with dtype=torch.bfloat16 every convolution takes bf16
  inputs, weights and bias and gives bf16, and every BatchNorm is a float32
  island (the flax `_BN.force_f32`), by explicit casts, not autocast;
- drop-connect in train mode on the skip blocks: keep ~ floor(keep + U)
  per sample, the branch divided by keep, rate drop_connect_rate * idx / 16
  for block idx, U from the caller's torch.Generator;
- masked pooling with frame counts: clip(ceil((n_frames - 2) / 32), 1, Tm)
  valid rows of the (Tm, Wm) map, mean over valid rows x Wm.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .bn import Stats, batch_norm

# (num_repeat, kernel, stride, expand, in_ch, out_ch, se_ratio)
B0_BLOCKS = (
    (1, 3, 1, 1, 32, 16, 0.25),
    (2, 3, 2, 6, 16, 24, 0.25),
    (2, 5, 2, 6, 24, 40, 0.25),
    (3, 3, 2, 6, 40, 80, 0.25),
    (3, 5, 1, 6, 80, 112, 0.25),
    (4, 5, 2, 6, 112, 192, 0.25),
    (1, 3, 1, 6, 192, 320, 0.25),
)
N_BLOCKS = sum(r for r, *_ in B0_BLOCKS)  # 16
HEAD_CH = 1280
BN_MOMENTUM = 0.99  # flax (torch 0.01)
BN_EPS = 1e-3


def _cast(t: Optional[torch.Tensor], dtype: Optional[torch.dtype]):
    return t if t is None or dtype is None else t.to(dtype)


class SameConv(nn.Conv2d):
    """nn.Conv2d with TF "SAME" padding (stride 1: symmetric; stride 2: the
    odd extra row / column at the end), computed in `dtype` when given."""

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        x, w, b = _cast(x, dtype), _cast(self.weight, dtype), _cast(self.bias, dtype)
        pads = []
        for n in x.shape[-2:]:
            total = max((math.ceil(n / s) - 1) * s + k - n, 0)
            pads.append((total // 2, total - total // 2))
        (ht, hb), (wl, wr) = pads
        if ht == hb and wl == wr:
            return F.conv2d(x, w, b, self.stride, (ht, wl), 1, self.groups)
        return F.conv2d(F.pad(x, [wl, wr, ht, hb]), w, b, self.stride, 0, 1, self.groups)


def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=BN_EPS)


class MBConv(nn.Module):
    def __init__(self, ci: int, co: int, k: int, s: int, e: int, se: float, drop: float):
        super().__init__()
        c = ci * e
        self.expand, self.drop = e, drop
        self.skip = s == 1 and ci == co
        if e != 1:
            self._expand_conv = SameConv(ci, c, 1, bias=False)
            self._bn0 = _bn(c)
        self._depthwise_conv = SameConv(c, c, k, stride=s, groups=c, bias=False)
        self._bn1 = _bn(c)
        sc = max(1, int(ci * se))
        self._se_reduce = SameConv(c, sc, 1)
        self._se_expand = SameConv(sc, c, 1)
        self._project_conv = SameConv(c, co, 1, bias=False)
        self._bn2 = _bn(co)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None,
                stats: Optional[Stats] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        inp = x
        if self.expand != 1:
            x = F.silu(batch_norm(self._bn0, self._expand_conv(x, dtype), BN_MOMENTUM, stats))
        x = F.silu(batch_norm(self._bn1, self._depthwise_conv(x, dtype), BN_MOMENTUM, stats))
        s = x.mean((2, 3), keepdim=True)
        s = self._se_expand(F.silu(self._se_reduce(s, dtype)), dtype)
        x = x * torch.sigmoid(s.to(x.dtype))
        x = batch_norm(self._bn2, self._project_conv(x, dtype), BN_MOMENTUM, stats)
        if not self.skip:
            return x
        if stats is not None and self.drop > 0:  # drop-connect in train mode
            keep = 1.0 - self.drop
            u = torch.rand((x.shape[0], 1, 1, 1), generator=gen, device=x.device)
            x = x / keep * torch.floor(keep + u)
        return x + inp


class EfficientNet(nn.Module):
    """Headless EfficientNet-B0: (B, 3, H, W) -> pooled (B, 1280), or the
    (B, 1280, H / 32, W / 32) map with return_map."""

    def __init__(self, drop_connect_rate: float = 0.2):
        super().__init__()
        self._conv_stem = SameConv(3, 32, 3, stride=2, bias=False)
        self._bn0 = _bn(32)
        blocks = []
        for r, k, s, e, ci, co, se in B0_BLOCKS:
            for j in range(r):
                idx = len(blocks)
                blocks.append(MBConv(ci if j == 0 else co, co, k, s if j == 0 else 1, e, se,
                                     drop_connect_rate * idx / N_BLOCKS))
        self._blocks = nn.ModuleList(blocks)
        self._conv_head = SameConv(320, HEAD_CH, 1, bias=False)
        self._bn1 = _bn(HEAD_CH)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None,
                stats: Optional[Stats] = None, gen: Optional[torch.Generator] = None,
                return_map: bool = False) -> torch.Tensor:
        x = F.silu(batch_norm(self._bn0, self._conv_stem(x, dtype), BN_MOMENTUM, stats))
        for blk in self._blocks:
            x = blk(x, dtype, stats, gen)
        x = F.silu(batch_norm(self._bn1, self._conv_head(x, dtype), BN_MOMENTUM, stats))
        return x if return_map else x.mean((2, 3))


class ColaEfficientNetEncoder(nn.Module):
    """The OPERA-CE encoder: cnn1 (1 -> 3 channels, 3x3 VALID, bias) then
    EfficientNet-B0. mel (B, T, F) [+ valid frame counts] -> (B, 1280)
    float32. stats: a dict for train mode (models/bn.py), None for eval;
    gen draws the drop-connect masks in train mode."""

    def __init__(self, drop_connect_rate: float = 0.1):
        super().__init__()
        self.cnn1 = nn.Conv2d(1, 3, 3)
        self.efficientnet = EfficientNet(drop_connect_rate)

    def forward(self, mel: torch.Tensor, n_frames: Optional[torch.Tensor] = None,
                dtype: Optional[torch.dtype] = None, stats: Optional[Stats] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.conv2d(_cast(mel[:, None], dtype), _cast(self.cnn1.weight, dtype),
                     _cast(self.cnn1.bias, dtype))
        fmap = self.efficientnet(x, dtype, stats, gen, return_map=n_frames is not None)
        if n_frames is None:
            return fmap
        # the VALID 3x3 stem drops 2 frames and the five stride-2 SAME
        # convolutions each halve with ceil: ceil((n - 2) / 32) valid rows
        Tm, Wm = fmap.shape[2], fmap.shape[3]
        valid = torch.ceil((n_frames.to(fmap.device) - 2).to(torch.float32) / 32.0)
        valid = torch.clamp(valid.to(torch.int64), 1, Tm)
        rows = (torch.arange(Tm, device=fmap.device)[None, :] < valid[:, None]).to(fmap.dtype)
        s = (fmap.sum(3) * rows[:, None, :]).sum(2)  # (B, C)
        return s / (valid * Wm).to(fmap.dtype)[:, None]
