"""The HTS-AT training forward with its swin blocks routed through the train
kernels of ops/swin_train.py — counterpart of
heart_murmur_detection_tpu/models/htsat_train_fused.py.

train-mode bn0 -> pad -> bicubic time resize -> fold -> 4x4 patch embed + LN
-> stages 0-2 through ops.swin_train.fused_swin_block_train -> stage 3 (C =
768 > max_fused_dim) as the plain float32 block -> LN -> token mean.
cola_train_apply adds the COLA projector (dropout -> g -> dropout ->
tanh(LN) -> dropout) and the bilinear `linear`.

Differences from the eval path (models.htsat_fused):
- bn0 normalises with the batch statistics and returns updated running
  statistics with flax semantics (biased variance, 0.9 old + 0.1 batch),
  which torch's BatchNorm train mode does not give (unbiased variance);
- DropPath keep multipliers (B,) in {0, 1/keep}, rates linspace(0,
  drop_path_rate, 12) over the blocks, are drawn here from an explicit
  torch.Generator and passed into the blocks (the same distribution as the
  JAX path, not the same draws);
- every weight's kernel layout (qkv padded per head, bf16) is built inside
  autograd each step (ops.swin.block_layout), and the relative-position bias
  is gathered with a fixed-order backward (ops.swin_train.rel_pos_bias);
- the products outside the blocks (patch embed, patch merging, stage 3, the
  projector) run in float32; the caller keeps TF32 off, as the JAX path runs
  them at HIGHEST or in full float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..audio.dsp import resize_bicubic_time
from ..ops.swin import _ln, block_layout
from ..ops.swin_train import fused_swin_block_train, rel_pos_bias
from ..parallel.mesh import sync_moments
from ..parallel.tensor import mesh_of
from . import tp_blocks

Stats = Tuple[torch.Tensor, torch.Tensor]  # bn0 (running_mean, running_var)


def _dropout(gen: Optional[torch.Generator], x: torch.Tensor, p: float) -> torch.Tensor:
    """flax nn.Dropout: keep ~ bernoulli(1 - p), kept values scaled 1/(1 - p)."""
    if p == 0.0:
        return x
    keep = 1.0 - p
    m = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(m, x / keep, torch.zeros((), device=x.device))


def _keep_mult(gen: Optional[torch.Generator], B: int, rate: float, device) -> torch.Tensor:
    """DropPath keep multipliers (B,): 0 or 1/keep (htsat.DropPath)."""
    if rate == 0.0:
        return torch.ones(B, device=device)
    keep = 1.0 - rate
    return torch.floor(keep + torch.rand(B, generator=gen, device=device)) / keep


def bn_train(x: torch.Tensor, weight, bias, stats: Stats, momentum: float = 0.9,
             eps: float = 1e-5, mesh=None) -> Tuple[torch.Tensor, Stats]:
    """flax BatchNorm train mode over (B, T) of x (B, T, F): normalise with
    the batch statistics (biased variance) and return the new running
    statistics momentum * old + (1 - momentum) * batch.

    With a mesh (parallel/mesh.py) the statistics are the global batch's
    (parallel/mesh.py::sync_moments: the JAX ex2 - bm^2, one autograd-aware
    all-reduce)."""
    bm, bv = sync_moments(x, (0, 1), mesh)
    y = (x - bm) * torch.rsqrt(bv + eps) * weight + bias
    mean, var = stats
    new = (
        momentum * mean + (1.0 - momentum) * bm.detach(),
        momentum * var + (1.0 - momentum) * bv.detach(),
    )
    return y, new


def _block_params(blk, bias: torch.Tensor, mm_dtype: torch.dtype):
    mods = dict(blk.named_modules())

    def get(name: str) -> torch.Tensor:
        mod, attr = name.rsplit(".", 1)
        return getattr(mods[mod], attr)

    return block_layout(get, blk.heads, bias, mm_dtype)


def htsat_encode_train(
    model,
    mel: torch.Tensor,
    gen: Optional[torch.Generator],
    stats: Stats,
    n_frames: Optional[torch.Tensor] = None,
    mm_dtype: torch.dtype = torch.float32,
    max_fused_dim: int = 384,
    deterministic: bool = False,
    impl: str = "kernel",
    mesh=None,
) -> Tuple[torch.Tensor, Stats]:
    """mel (B, T, F) -> (latent (B, 768), new bn0 running statistics).

    model: a models.htsat.HTSAT; stats: the bn0 running statistics to update
    (two encoder calls chain them), or None for bn0 on its running
    statistics, as the eval forward normalises (None comes back; the
    input gradient of analysis/saliency.py takes this route). mm_dtype bf16 runs stages up to
    max_fused_dim through the train kernels in bf16 (impl: see
    ops.swin_train.fused_swin_block_train); float32 runs every block in
    float32, the same stages through the train kernels' float32 mode
    (swin_attn_f32 / swin_mlp_f32 forward, swin_attn_bwd_f32 /
    swin_mlp_bwd_f32 / swin_wgrad_f32 backward on a card). deterministic=True keeps the DropPath multipliers at 1. mesh:
    this rank's share of a data-parallel batch, bn0 on the global
    statistics (bn_train). A model placed by parallel.tensor.shard_model
    runs its blocks through models/tp_blocks.swin_block (plain route)."""
    cfg = model.config
    B, T, Fb = mel.shape
    dev = mel.device
    bn = model.bn0
    if stats is None:  # the eval route: bn0 on its running statistics
        x = (mel.to(torch.float32) - bn.running_mean) * torch.rsqrt(
            bn.running_var + bn.eps) * bn.weight + bn.bias
        new_stats = None
    else:
        x, new_stats = bn_train(mel.to(torch.float32), bn.weight, bn.bias, stats, mesh=mesh)

    target_T = cfg.spec_size * cfg.freq_ratio
    if n_frames is None:
        n_frames = torch.full((B,), T, dtype=torch.int32, device=dev)
    if T < target_T:
        x = F.pad(x, (0, 0, 0, target_T - T))
    x = resize_bicubic_time(x, n_frames, target_T)
    x = x.reshape(B, cfg.freq_ratio, cfg.spec_size, Fb)
    x = x.permute(0, 1, 3, 2).reshape(B, cfg.freq_ratio * Fb, cfg.spec_size)

    # patch embed: a stride == size conv as a float32 product over patches
    pe = model.patch_embed
    p = cfg.patch_size
    Hp, Wp = x.shape[1] // p, x.shape[2] // p
    patches = x.reshape(B, Hp, p, Wp, p).permute(0, 1, 3, 2, 4).reshape(B, Hp * Wp, p * p)
    w = pe.proj.weight.reshape(pe.proj.weight.shape[0], p * p)
    x = _ln(patches @ w.T + pe.proj.bias, pe.norm.weight, pe.norm.bias)

    act = torch.bfloat16 if mm_dtype == torch.bfloat16 else torch.float32
    dpr = np.linspace(0, cfg.drop_path_rate, sum(cfg.depths))
    stages = model.train_stages(dev)
    tp = mesh_of(model) is not None
    res = (Hp, Wp)
    for i_layer, layer in enumerate(model.layers):
        H, W = res
        dim = int(cfg.embed_dim * 2**i_layer)
        st = stages[i_layer]
        fused = dim <= max_fused_dim and st.window == cfg.window_size
        for b, blk in enumerate(layer.blocks):
            shift = st.shift if b % 2 else 0
            rate = float(dpr[sum(cfg.depths[:i_layer]) + b])
            if deterministic:
                k1 = k2 = torch.ones(B, device=dev)
            else:
                k1 = _keep_mult(gen, B, rate, dev)
                k2 = _keep_mult(gen, B, rate, dev)
            mask = st.mask if shift else None
            if tp:
                mm = mm_dtype if fused else torch.float32
                xs = x.reshape(B, H, W, dim).to(act if fused else torch.float32)
                xs = tp_blocks.swin_block(xs, blk, st, shift, k1, k2, mm)
                x = xs.reshape(B, H * W, dim).to(torch.float32)
                continue
            bias = rel_pos_bias(blk.attn.relative_position_bias_table, st.idx, st.seg)
            if fused:
                pb = _block_params(blk, bias, mm_dtype)
                xs = x.reshape(B, H, W, dim).to(act)
                xs = fused_swin_block_train(xs, pb, mask, shift, k1, k2, impl)
            else:  # the plain float32 block (_block_jnp_train)
                pb = _block_params(blk, bias, torch.float32)
                xs = x.reshape(B, H, W, dim).to(torch.float32)
                xs = fused_swin_block_train(xs, pb, mask, shift, k1, k2, "autograd")
            x = xs.reshape(B, H * W, dim).to(torch.float32)
        if i_layer < len(model.layers) - 1:
            pm = layer.downsample
            xs = x.reshape(B, H, W, dim)
            xs = torch.cat(
                [xs[:, 0::2, 0::2], xs[:, 1::2, 0::2], xs[:, 0::2, 1::2], xs[:, 1::2, 1::2]],
                dim=-1,
            ).reshape(B, -1, 4 * dim)
            x = _ln(xs, pm.norm.weight, pm.norm.bias) @ pm.reduction.weight.T
            res = (H // 2, W // 2)

    x = _ln(x, model.norm.weight, model.norm.bias)
    return x.mean(dim=1), new_stats


def cola_train_apply(
    model,
    x1: torch.Tensor,
    x2: torch.Tensor,
    gen: Optional[torch.Generator],
    p_drop: float = 0.1,
    mm_dtype: torch.dtype = torch.float32,
    max_fused_dim: int = 384,
    deterministic: bool = False,
    impl: str = "kernel",
    mesh=None,
) -> Tuple[Tuple[torch.Tensor, torch.Tensor], Stats]:
    """Cola train-mode pair forward with the fused encoder: (x1, x2) ->
    ((z1 @ W^T, z2), new bn0 running statistics). model: a models.cola.Cola.
    The bn0 statistics chain through the two encoder calls in order, like
    two sequential flax mutable applies; nothing is written into the model.
    mesh: x1, x2 are this rank's rows of a data-parallel batch (bn0 on the
    global statistics); the caller gathers the outputs for the loss."""
    enc = model.htsat
    stats = (enc.bn0.running_mean, enc.bn0.running_var)
    kw = dict(mm_dtype=mm_dtype, max_fused_dim=max_fused_dim,
              deterministic=deterministic, impl=impl, mesh=mesh)
    h1, stats = htsat_encode_train(enc, x1, gen, stats, **kw)
    h2, stats = htsat_encode_train(enc, x2, gen, stats, **kw)
    p = 0.0 if deterministic else p_drop
    z1 = model.project(h1, gen, p)
    z2 = model.project(h2, gen, p)
    return (model.linear(z1), z2), stats
