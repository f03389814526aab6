"""The transformer blocks' forwards on a model placed by
parallel/tensor.py::shard_model (Megatron tensor parallelism over the model
axis), written on torch autograd for the plain route: the JAX package runs
its XLA graphs and no kernel under a tensor axis, and so does the port.

Each block: the replicated activations go through LayerNorm on every model
rank, then `copy` (identity forward, all-reduce backward) into the
column-parallel qkv / fc1, which give this rank's heads / hidden columns;
attention runs on the rank's heads alone; the row-parallel proj / fc2 give
partial products that one all-reduce sums (`reduce`), and the bias, the
DropPath multiplier and the residual follow on the whole activations. A
layer that the rule leaves replicated (a dimension the model axis does not
divide) runs whole, without a collective.

A block whose heads the model axis does not divide takes the head split
(parallel/tensor.py): its qkv gives the rank's contiguous 3C / n columns,
one all-gather (`tensor.gather`) makes every head's q, k and v, attention
runs over all heads on every model rank (the whole relative-position
table, tau and meta-MLP bias), and the rank's C / n columns of the head
outputs (`tensor.split`, whose backward all-gathers their cotangent) go
into the row-parallel proj. The rounding points are those of
the plain versions (ops/swin.py::swin_attn_ref / swin_mlp_ref,
ops/vit.py::vit_attn_ref / vit_mlp_ref, models/vit_mae.py's decoder), so in
float32 a block is the single-device block up to the order of the sums.

- swin_block: the HTS-AT block (models/htsat_train_fused.htsat_encode_train
  and models/htsat_fused.htsat_apply_fused dispatch to it), the local
  heads' columns of the relative-position table, the shift mask;
- vit_block: the ViT block of the MAE encoders (models/mae_train_fused.py,
  models/vit_fused.py) and of HeAR (models/hear.py), q scaled in float32
  before the matmul-dtype cast;
- swinv2cr_block: the SwinV2-CR decoder block (models/vit_mae.py), the
  local heads' tau, the continuous position bias of the meta-MLP with a
  column-parallel fc1 and a row-parallel fc2, whose whole output each rank
  reads its heads' columns of (through `copy`, so both layers see every
  head's gradient);
- mlp_head: the fine-tuning MLP head (models/heads.py), fc1 column- and fc2
  row-parallel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.swin import _ln, _mmf
from ..ops.swin_train import rel_pos_bias
from ..ops.vit import LN_EPS, _head_outputs
from ..parallel import tensor


def _mlp(x: torch.Tensor, mlp, norm_out: torch.Tensor, mm_dtype, act) -> torch.Tensor:
    """fc2(gelu(fc1(norm_out))) in float32: fc1's output rounded to act."""
    m = tensor.column(tensor.column_in(norm_out, mlp.fc1), mlp.fc1, mm_dtype)
    m = F.gelu(m, approximate="none").to(act)
    return tensor.row(m, mlp.fc2, mm_dtype)


def _qkv(attn, h: torch.Tensor, mm_dtype, act, weight=None, bias=None) -> torch.Tensor:
    """The qkv columns this rank attends with (h has passed column_in):
    the rank's heads' (split by heads, or replicated: all), or in a
    head-split block every head's, all-gathered from the ranks' contiguous
    parts; rounded to act."""
    qkv = tensor.column(h, attn.qkv, mm_dtype, weight, bias).to(act)
    if tensor.head_split(attn):
        qkv = tensor.gather(qkv, tensor.placement(attn.qkv.weight).mesh)
    return qkv


def _proj(attn, o: torch.Tensor, mm_dtype) -> torch.Tensor:
    """The row-parallel proj of the head outputs o: in a head-split block o
    holds every head and the rank hands on its columns (`tensor.split`),
    where the proj is sharded."""
    if tensor.head_split(attn) and tensor.sharded(attn.proj):
        o = tensor.split(o, tensor.placement(attn.proj.weight).mesh)
    return tensor.row(o, attn.proj, mm_dtype)


def _local_heads(attn, hd: int) -> int:
    """The heads this rank attends over: all in a head-split block."""
    if tensor.head_split(attn):
        return tensor.placement(attn.qkv.weight).size // (3 * hd)
    return attn.qkv.weight.shape[0] // (3 * hd)


def swin_block(x: torch.Tensor, blk, stage, shift: int, k1: Optional[torch.Tensor],
               k2: Optional[torch.Tensor], mm_dtype: torch.dtype) -> torch.Tensor:
    """One HTS-AT swin block on spatial x (B, H, W, C), activations in x's
    dtype: y = h1 + k2 mlp(h1), h1 = x + k1 attn(x). stage: the stage's
    models.htsat.TrainStage (window, relative-position index, shift mask);
    k1, k2: DropPath keep multipliers (B,) or None."""
    B, H, W, C = x.shape
    act, mm = x.dtype, mm_dtype
    attn, window = blk.attn, stage.window
    hd = C // blk.heads
    heads = _local_heads(attn, hd)
    nwh, nww = H // window, W // window
    N, Bn = window * window, B * (H // window) * (W // window)
    xr = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
    xw = xr.reshape(B, nwh, window, nww, window, C).permute(0, 1, 3, 2, 4, 5).reshape(Bn, N, C)
    h = tensor.column_in(_ln(xw, blk.norm1.weight, blk.norm1.bias), attn.qkv)
    qkv = _qkv(attn, h, mm, act).reshape(Bn, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    qs = q * torch.tensor(hd**-0.5, dtype=act, device=q.device)
    bias = rel_pos_bias(tensor.local(attn.relative_position_bias_table), stage.idx, stage.seg)
    a = _mmf(qs, mm) @ _mmf(k, mm).transpose(-1, -2) + bias
    if shift:
        a = (a.reshape(B, nwh * nww, heads, N, N) + stage.mask[None, :, None]).reshape(
            Bn, heads, N, N)
    o = (_mmf(torch.softmax(a, -1), mm) @ _mmf(v, mm)).to(act)
    o = _proj(attn, o.permute(0, 2, 1, 3).reshape(Bn, N, heads * hd), mm)
    if k1 is not None:
        o = k1.reshape(B, 1, 1).repeat_interleave(nwh * nww, 0) * o
    h1 = (xw.to(torch.float32) + o).to(act)
    h1 = h1.reshape(B, nwh, nww, window, window, C).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)
    if shift:
        h1 = torch.roll(h1, (shift, shift), (1, 2))
    m = _mlp(h1, blk.mlp, _ln(h1, blk.norm2.weight, blk.norm2.bias), mm, act)
    if k2 is not None:
        m = k2.reshape(B, 1, 1, 1) * m
    return (h1.to(torch.float32) + m).to(act)


def vit_block(x: torch.Tensor, blk, n_real: Optional[int], mm_dtype: torch.dtype) -> torch.Tensor:
    """One ViT block (models.vit_mae.ViTBlock) on tokens x (B, Np, C) in x's
    dtype; n_real < Np masks the padded keys (the stable softmax of
    ops.vit)."""
    B, Np, C = x.shape
    act, mm = x.dtype, mm_dtype
    attn = blk.attn
    hd = C // blk.num_heads
    heads = _local_heads(attn, hd)
    if n_real is not None and n_real >= Np:
        n_real = None
    # q's rows scaled by hd^-0.5 in float32 before the cast (vit_block_layout):
    # the rank's rows among the first C of the full qkv
    w, b = attn.qkv.weight, tensor.local(attn.qkv.bias)
    pl = tensor.placement(attn.qkv.weight)
    if pl is None or pl.kind != "shard":
        q_rows = torch.arange(w.shape[0], device=w.device) < C
    else:
        q_rows = pl.index(pl.mesh.model.rank, w.device) < C
    scale = torch.where(q_rows, hd**-0.5, 1.0).to(w.dtype)
    w, b = w * scale[:, None], b * scale
    h = tensor.column_in(_ln(x, blk.norm1.weight, blk.norm1.bias, LN_EPS).to(act), attn.qkv)
    qkv = _qkv(attn, h, mm, act, w, b).reshape(B, Np, 3, heads, hd).permute(2, 0, 3, 1, 4)
    o = _proj(attn, _head_outputs(qkv, mm, n_real, "stable", act), mm)
    x = (x.to(torch.float32) + o).to(act)
    m = _mlp(x, blk.mlp, _ln(x, blk.norm2.weight, blk.norm2.bias, LN_EPS).to(act), mm, act)
    return (x.to(torch.float32) + m).to(act)


def _meta_bias(attn, rel: torch.Tensor, heads: int) -> torch.Tensor:
    """The rank's heads' continuous position bias (heads, N, N) float32
    (every head's in a head-split block)."""
    mlp = attn.meta_mlp
    h = torch.relu(tensor.column(rel, mlp.fc1, torch.float32))
    bias = tensor.row(h, mlp.fc2, torch.float32)  # (N*N, all heads), on every rank
    if tensor.sharded(attn.qkv) and not tensor.head_split(attn):
        mesh = tensor.placement(attn.qkv.weight).mesh
        bias = tensor.copy(bias, mesh)
        bias = bias.narrow(1, mesh.model.rank * heads, heads)
    N = math.isqrt(rel.shape[0])
    return bias.T.reshape(heads, N, N)


def _swinv2cr_attn(attn, x: torch.Tensor, mask, rel, mm_dtype) -> torch.Tensor:
    """SwinV2CRAttention.forward on the rank's heads: windows (Bw, L, C) ->
    the row-parallel proj's summed output (Bw, L, C) float32."""
    Bw, L, C = x.shape
    hd = C // attn.num_heads
    nh = _local_heads(attn, hd)
    qkv = _qkv(attn, tensor.column_in(x, attn.qkv), mm_dtype, torch.float32)
    qkv = qkv.reshape(Bw, L, 3, nh, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    tau = tensor.local(attn.tau).clamp(min=0.01).reshape(1, nh, 1, 1)
    qn = q.norm(dim=-1, keepdim=True)
    kn = k.norm(dim=-1, keepdim=True)
    if mm_dtype == torch.float32:
        denom = torch.clamp(qn @ kn.transpose(-1, -2), min=1e-6)
        a = (q @ k.transpose(-1, -2)) / denom / tau
    else:
        q = q / qn.clamp(min=1e-3) / tau
        k = k / kn.clamp(min=1e-3)
        a = _mmf(q, mm_dtype) @ _mmf(k, mm_dtype).transpose(-1, -2)
    a = a + _meta_bias(attn, rel, nh)[None]
    if mask is not None:
        nW = mask.shape[0]
        a = (a.reshape(Bw // nW, nW, nh, L, L) + mask[None, :, None]).reshape(Bw, nh, L, L)
    a = torch.softmax(a, -1)
    out = (_mmf(a, mm_dtype) @ _mmf(v, mm_dtype)).transpose(1, 2).reshape(Bw, L, nh * hd)
    return _proj(attn, out, mm_dtype)


def swinv2cr_block(blk, x: torch.Tensor, mm_dtype: torch.dtype) -> torch.Tensor:
    """SwinV2CRBlock.forward (post-norm) with the rank's heads and hidden
    columns: x (B, L, C) float32."""
    from .vit_mae import window_partition_2d, window_reverse_2d

    H, W = blk.feat_size
    B, L, C = x.shape
    if L != H * W:
        H = L // W
    wh, ww = min(blk.window[0], H), min(blk.window[1], W)
    sh = 0 if H <= blk.window[0] else blk.shift[0]
    sw = 0 if W <= blk.window[1] else blk.shift[1]
    h = x.reshape(B, H, W, C)
    if sh or sw:
        h = torch.roll(h, (-sh, -sw), (1, 2))
    rel, mask = blk._window_consts(H, W, (wh, ww), (sh, sw), x.device)
    hw = _swinv2cr_attn(blk.attn, window_partition_2d(h, (wh, ww)), mask, rel, mm_dtype)
    h = window_reverse_2d(hw, (wh, ww), H, W)
    if sh or sw:
        h = torch.roll(h, (sh, sw), (1, 2))
    x = x + blk.norm1(h.reshape(B, L, C))
    m = tensor.column(tensor.column_in(x, blk.mlp.fc1), blk.mlp.fc1, mm_dtype)
    m = tensor.row(F.gelu(m, approximate="none"), blk.mlp.fc2, mm_dtype)
    return x + blk.norm2(m)


def mlp_head(head, x: torch.Tensor) -> torch.Tensor:
    """models.heads.Head "mlp": fc2(relu(fc1(x))), float32."""
    h = torch.relu(tensor.column(tensor.column_in(x, head.fc1), head.fc1, torch.float32))
    return tensor.row(h, head.fc2, torch.float32)
