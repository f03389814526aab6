"""Training ViT block for the MAE encoders: the counterpart of
heart_murmur_detection_tpu/ops/pallas_vit_train.py::fused_vit_block_train
(TPU K9, :703) as a torch.autograd.Function over hand-written CUDA kernels.

  forward    h1 = x + attn(x), y = h1 + mlp(h1): the eval kernels vit_qkv,
             vit_attn (stable softmax), vit_proj and vit_mlp of ops/vit.py, whose
             bodies are K9's forward (`_fwd_full_kernel` :121 runs
             `_attn_half` / `_mlp_half`, the eval bodies); saves (x, h1)
  backward   vit_mlp_bwd   (h1, dy) -> dh1 + per-token operands + per-block
                           column sums: csrc/swin_mlp_bwd.cu (three grid
                           launches) with LN eps 1e-6 and no DropPath
                           multiplier (TPU `_bwd_mlp_common` :163)
             vit_attn_bwd  (x, dh1) -> dx + per-token operands + per-block
                           column sums: csrc/vit_attn_bwd.cu, six grid
                           launches on wgmma, the first vit_qkv.cu's LN1 +
                           qkv body (TPU `_attn_bwd_core` :246)
             swin_wgrad / swin_reduce (ops/swin_train.py) for the weight
                           gradients and the column sums, each summed in a
                           fixed order

The float32 mode (float32 activations and weights, mm_dtype=float32: the
TPU bodies at Precision.HIGHEST) has kernels of its own on the CUDA cores,
counted apart, at C 384 and 768: the forward is ops/vit.py's vit_qkv_f32,
vit_attn_f32 (stable softmax), vit_proj_f32 and vit_mlp_f32; the backward

  vit_mlp_bwd_f32   csrc/swin_mlp_bwd_f32.cu (seven grid launches) with LN
                    eps 1e-6 and no multiplier
  vit_attn_bwd_f32  csrc/vit_attn_bwd_f32.cu: eight grid launches, the
                    attention core as a query pass (o_pre, dq, each row's
                    statistics) and a key pass (dk, dv), FFMA throughout
  swin_wgrad_f32 / swin_reduce for the weight gradients and column sums.

They emit the same operand rows and partial rows in float32.

The TPU package has two weight-gradient modes, "acc" (sums in a resident
VMEM block over its sequential grid) and "emit" (per-token operands for
outside products), chosen by a VMEM planner (`train_plan` :404); both are
the same math. On the card one design serves both: the backward kernels
emit the operands and per-block column sums, swin_wgrad multiplies the
operands over fixed token chunks and sums the chunks in order in the same
launch, and swin_reduce adds the column sums in order, so nothing is summed
with atomics and two runs give bitwise-equal gradients.

The attention scale 1/sqrt(hd) is folded into the q rows of w_qkv and the q
bias in float32 before the bf16 cast (ops.vit.vit_block_layout, built inside
autograd), so autograd maps the gradients back to the float32 parameters
through the fold and the cast, as the JAX package differentiates its
`_prep_vit_train_weights`.

Sequence padding as the JAX package: tokens padded to a multiple of 16
(ops.vit.pad_tokens), key columns >= n_real masked to -1e9 (exact zeros in
P). The caller uses y[:, :n_real] only, so dy is 0 on padded rows, which
keeps dx = 0 there and adds nothing to any weight gradient.

Rounding (bfloat16 activations and weights, float32 accumulation, LN,
softmax and GELU): the plain versions below round where the TPU bodies
round (`_bwd_mlp_common` :163, `_attn_bwd_core` :246), and the weight
gradients of the bf16 matrices round to bf16 at the Function's boundary, as
the JAX custom_vjp returns them in the weights' dtype (:670-674).

Dispatch: a CPU tensor runs the plain versions; a CUDA bfloat16 block
launches the bf16 kernels, CUDA float32 activations with float32 weights the
float32 kernels; any other CUDA pairing raises before the first launch (in
vit_qkv's checks). A kernel that fails to launch raises;
nothing falls back to the plain versions on a card. impl="plain" runs the
plain versions with their explicit backward on any device; impl="autograd"
differentiates the plain forward with torch autograd (the strict float32
path).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import vit, vit_plan
from .swin import _check_aligned, _check_launch, _cuda_stream, _mmf, _ptr
from .swin_plan import F32_ROW_THREADS, F32_THREADS, F32_TILE_COLS, F32_TILE_ROWS
from .swin_train import (
    TOKEN_TILE,
    _blocks_for,
    _lib,
    _ln_bwd_input,
    _ln_stats,
    mlp_bwd_f32_launch,
    mlp_bwd_launch,
    swin_mlp_bwd_ref,
    swin_reduce,
    swin_wgrad,
    swin_wgrad_f32,
)
from .vit import HD, LN_EPS, MASK, VitBlockParams

TRAIN_WIDTHS = (384, 768)  # the MAE encoders the backward kernels train (not HeAR's 1024)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def vit_mlp_bwd_ref(h1: torch.Tensor, dy: torch.Tensor, p: VitBlockParams, rows: bool = False):
    """Plain version of vit_mlp_bwd (`_bwd_mlp_common` :163): y = h1 +
    mlp(LN2(h1)), given dy (B, Np, C) -> (dh1 in h1's dtype, float32
    gradients of ln2_w, ln2_b, w_fc1, b_fc1, w_fc2, b_fc2 in the torch (out,
    in) layout). rows=True also returns the bf16 operand rows the kernel
    emits: (LN2(h1), GELU(a1), da1)."""
    return swin_mlp_bwd_ref(h1, dy, None, p, LN_EPS, rows)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, Np, heads hd) -> (B, heads, Np, hd)."""
    B, Np, C = t.shape
    return t.reshape(B, Np, heads, C // heads).permute(0, 2, 1, 3)


def _unheads(t: torch.Tensor) -> torch.Tensor:
    """(B, heads, Np, hd) -> (B, Np, heads hd)."""
    B, H, Np, hd = t.shape
    return t.permute(0, 2, 1, 3).reshape(B, Np, H * hd)


def vit_attn_bwd_ref(
    x: torch.Tensor,
    dh1: torch.Tensor,
    p: VitBlockParams,
    n_real: Optional[int] = None,
    rows: bool = False,
):
    """Plain version of vit_attn_bwd (`_attn_bwd_core` :246): h1 = x +
    attn(x), given dh1 (B, Np, C) -> (dx in x's dtype, float32 gradients of
    ln1_w, ln1_b, w_qkv, b_qkv (q rows scaled, as laid out), w_proj, b_proj).
    It rounds where the TPU body rounds: LN1(x), qkv, do = dh1 W_proj, the
    stable softmax's P for P V and dv, o_pre, dS, dq, dk and dv. rows=True
    also returns the bf16 operand rows the kernel emits: (LN1(x), o_pre,
    dqkv) as (B Np, C), (B Np, C), (B Np, 3C)."""
    act, mm = x.dtype, p.mm_dtype
    B, Np, C = x.shape
    heads = p.heads
    xhat, rstd = _ln_stats(x, LN_EPS)
    h = (xhat * p.ln1_w + p.ln1_b).to(act)
    hb = _mmf(h, mm)
    qkv = (hb @ _mmf(p.w_qkv, mm).T + p.b_qkv).to(act)
    q, k, v = (_heads(t, heads) for t in qkv.split(C, -1))
    dh1f = dh1.to(torch.float32)
    do = _heads((_mmf(dh1f, mm) @ _mmf(p.w_proj, mm)).to(act), heads)
    s = _mmf(q, mm) @ _mmf(k, mm).transpose(-1, -2)
    if n_real is not None and n_real < Np:
        s = torch.where(torch.arange(Np, device=x.device) < n_real, s, MASK)
    pr = torch.softmax(s, -1)
    vb, dob = _mmf(v, mm), _mmf(do, mm)
    o_pre = _unheads((_mmf(pr, mm) @ vb).to(act))
    dp = dob @ vb.transpose(-1, -2)
    ds = pr * (dp - (dp * pr).sum(-1, keepdim=True))
    dsb = _mmf(ds.to(act), mm)
    dq = (dsb @ _mmf(k, mm)).to(act)
    dk = (dsb.transpose(-1, -2) @ _mmf(q, mm)).to(act)
    dv = (_mmf(pr.to(act), mm).transpose(-1, -2) @ dob).to(act)
    dqkv = torch.cat([_unheads(dq), _unheads(dk), _unheads(dv)], -1).reshape(B * Np, 3 * C)
    dqkvb = _mmf(dqkv, mm)
    dh = (dqkvb @ _mmf(p.w_qkv, mm)).reshape(B, Np, C)
    dx = (dh1f + _ln_bwd_input(dh, xhat, rstd, p.ln1_w)).to(act)
    n = B * Np
    grads = {
        "ln1_w": (dh * xhat).reshape(n, C).sum(0),
        "ln1_b": dh.reshape(n, C).sum(0),
        "w_qkv": dqkvb.T @ hb.reshape(n, C),
        "b_qkv": dqkv.to(torch.float32).sum(0),
        "w_proj": _mmf(dh1f.reshape(n, C), mm).T @ _mmf(o_pre.reshape(n, C), mm),
        "b_proj": dh1f.reshape(n, C).sum(0),
    }
    if rows:
        return dx, grads, (h.reshape(n, C), o_pre.reshape(n, C), dqkv)
    return dx, grads


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_bwd_args(x: torch.Tensor, g: torch.Tensor, p: VitBlockParams,
                    dtype: torch.dtype = torch.bfloat16):
    vit._check_cuda_args(x, p, True, dtype)  # the mode's dtype, head dim 64, tokens padded to 16
    if x.shape[2] not in TRAIN_WIDTHS:
        raise ValueError(f"the ViT backward kernels take C in {TRAIN_WIDTHS}, got {x.shape[2]}")
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("the incoming gradient must match the activation")
    if (x.shape[0] * x.shape[1]) % TOKEN_TILE:
        raise ValueError(f"B Np must be a multiple of {TOKEN_TILE}, got {tuple(x.shape[:2])}")
    return g.contiguous()


def vit_mlp_bwd_launch(h1: torch.Tensor, dy: torch.Tensor, p: VitBlockParams):
    """The vit_mlp_bwd call on CUDA tensors (csrc/swin_mlp_bwd.cu, three
    grid launches, LN eps 1e-6, no multiplier): (dh1, (LN2(h1), GELU(a1),
    da1) operand rows, partial rows [db1 | db2 | dLN2 w | dLN2 b])."""
    dy = _check_bwd_args(h1, dy, p)
    B, Np, C = h1.shape
    dh1, (m_g, g_g, _, da1_g), part = mlp_bwd_launch(
        "vit_mlp_bwd", h1.view(-1, C), dy.view(-1, C), None, p, Np, LN_EPS)
    vit_mlp_bwd.launches += 1
    return dh1.view(h1.shape), (m_g, g_g, da1_g), part


def vit_mlp_bwd(
    h1: torch.Tensor, dy: torch.Tensor, p: VitBlockParams
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Backward of the MLP half (see vit_mlp_bwd_ref for the math)."""
    if h1.device.type == "cpu":
        return vit_mlp_bwd_ref(h1, dy, p)
    if vit._is_f32(h1, p):
        return vit_mlp_bwd_f32(h1, dy, p)
    dh1, (m_g, g_g, da1_g), part = vit_mlp_bwd_launch(h1, dy, p)
    C, hidden = h1.shape[-1], p.hidden
    db1, db2, dln2w, dln2b = swin_reduce(part).split([hidden, C, C, C])
    return dh1, {
        "ln2_w": dln2w, "ln2_b": dln2b,
        "w_fc1": swin_wgrad(da1_g, m_g), "b_fc1": db1,
        "w_fc2": swin_wgrad(dy.reshape(-1, C), g_g), "b_fc2": db2,
    }


def vit_attn_bwd_launch(
    x: torch.Tensor, dh1: torch.Tensor, p: VitBlockParams, n_real: Optional[int] = None
):
    """The vit_attn_bwd launch on CUDA tensors (csrc/vit_attn_bwd.cu, six
    grid launches in one call, every kernel named vit_attn_bwd_*): (dx,
    (LN1(x), o_pre, dqkv) operand rows, per-block partial rows [db_qkv |
    db_proj | dLN1 w | dLN1 b])."""
    dh1 = _check_bwd_args(x, dh1, p)
    B, Np, C = x.shape
    n_real = Np if n_real is None else n_real
    if not 0 < n_real <= Np:
        raise ValueError(f"n_real {n_real} outside (0, {Np}]")
    n, heads = B * Np, p.heads
    tpb, G = _blocks_for(n // TOKEN_TILE)
    e = lambda *shape, dtype=x.dtype: torch.empty(*shape, dtype=dtype, device=x.device)
    h_g, opre_g, dqkv_g = e(n, C), e(n, C), e(n, 3 * C)
    part = e(G, 6 * C, dtype=torch.float32)
    # scratch: head-major q, k, v and do, the query rows' statistics, dh
    qkv_ws, do_ws = e(3, B, heads, Np, HD), e(B, heads, Np, HD)
    stats_ws = e(3, B * heads * Np, dtype=torch.float32)
    dh_ws = e(n, C, dtype=torch.float32)
    dx = torch.empty_like(x)
    rc = _lib().vit_attn_bwd_launch(
        _ptr(x), _ptr(dh1), _ptr(dx), _ptr(p.w_qkv), _ptr(p.b_qkv), _ptr(p.w_proj),
        _ptr(p.ln1_w), _ptr(p.ln1_b), _ptr(h_g), _ptr(opre_g), _ptr(dqkv_g), _ptr(part),
        _ptr(qkv_ws), _ptr(do_ws), _ptr(stats_ws), _ptr(dh_ws),
        B, Np, C, heads, n_real, tpb, LN_EPS, _cuda_stream(x),
    )
    _check_launch("vit_attn_bwd", rc)
    vit_attn_bwd.launches += 1
    return dx, (h_g, opre_g, dqkv_g), part


def rows_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) b (K, N) -> float32 (M, N) on vit_attn_bwd's token-row
    product (the GEMM core with A K-major and B MN-major, the float32 row
    store of its dh launch) alone. For the tests only: no path calls it, and
    it counts no launches. On the CPU the float32 product of the operands;
    on the card bf16 operands, K and N multiples of 8."""
    if a.device.type == "cpu":
        return a.to(torch.float32) @ b.to(torch.float32)
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"rows_mm takes bfloat16 operands, got {a.dtype} / {b.dtype}")
    if (a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] or a.shape[1] % 8
            or b.shape[1] % 8 or not (a.is_contiguous() and b.is_contiguous())
            or a.device != b.device):
        raise ValueError(f"rows_mm takes contiguous (M, K) x (K, N) on one device, K and N "
                         f"multiples of 8; got {tuple(a.shape)} x {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty(M, N, dtype=torch.float32, device=a.device)
    _check_launch("rows_mm", _lib().vit_mm_launch(_ptr(a), _ptr(b), _ptr(out), M, N, K,
                                                  _cuda_stream(a)))
    return out


def vit_attn_bwd(
    x: torch.Tensor, dh1: torch.Tensor, p: VitBlockParams, n_real: Optional[int] = None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Backward of the attention half (see vit_attn_bwd_ref for the math)."""
    if x.device.type == "cpu":
        return vit_attn_bwd_ref(x, dh1, p, n_real)
    if vit._is_f32(x, p):
        return vit_attn_bwd_f32(x, dh1, p, n_real)
    dx, (h_g, opre_g, dqkv_g), part = vit_attn_bwd_launch(x, dh1, p, n_real)
    C = x.shape[-1]
    dbqkv, dbproj, dln1w, dln1b = swin_reduce(part).split([3 * C, C, C, C])
    return dx, {
        "ln1_w": dln1w, "ln1_b": dln1b,
        "w_qkv": swin_wgrad(dqkv_g, h_g), "b_qkv": dbqkv,
        "w_proj": swin_wgrad(dh1.reshape(-1, C), opre_g), "b_proj": dbproj,
    }


# ---------------------------------------------------------------------------
# the float32 mode
# ---------------------------------------------------------------------------


def vit_mlp_bwd_f32_launch(h1: torch.Tensor, dy: torch.Tensor, p: VitBlockParams):
    """The vit_mlp_bwd_f32 call on CUDA float32 tensors (csrc/swin_mlp_bwd_f32.cu,
    seven grid launches, LN eps 1e-6, no multiplier): (dh1, (LN2(h1),
    GELU(a1), da1) operand rows, partial rows [db1 | db2 | dLN2 w | dLN2 b])."""
    dy = _check_bwd_args(h1, dy, p, torch.float32)
    B, Np, C = h1.shape
    dh1, (m_g, g_g, _, da1_g), part = mlp_bwd_f32_launch(
        "vit_mlp_bwd_f32", h1.view(-1, C), dy.view(-1, C), None, p, Np, LN_EPS)
    vit_mlp_bwd_f32.launches += 1
    return dh1.view(h1.shape), (m_g, g_g, da1_g), part


def vit_mlp_bwd_f32(
    h1: torch.Tensor, dy: torch.Tensor, p: VitBlockParams
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Backward of the MLP half in float32 (h1, dy and p float32; see
    vit_mlp_bwd_ref for the math): csrc/swin_mlp_bwd_f32.cu, swin_reduce and
    swin_wgrad_f32 on a card, the plain version on the CPU."""
    if h1.device.type == "cpu":
        return vit_mlp_bwd_ref(h1, dy, p)
    dh1, (m_g, g_g, da1_g), part = vit_mlp_bwd_f32_launch(h1, dy, p)
    C, hidden = h1.shape[-1], p.hidden
    db1, db2, dln2w, dln2b = swin_reduce(part).split([hidden, C, C, C])
    return dh1, {
        "ln2_w": dln2w, "ln2_b": dln2b,
        "w_fc1": swin_wgrad_f32(da1_g, m_g), "b_fc1": db1,
        "w_fc2": swin_wgrad_f32(dy.reshape(-1, C), g_g), "b_fc2": db2,
    }


def vit_attn_bwd_f32_launch(
    x: torch.Tensor, dh1: torch.Tensor, p: VitBlockParams, n_real: Optional[int] = None
):
    """The vit_attn_bwd_f32 call on CUDA float32 tensors (csrc/vit_attn_bwd_f32.cu,
    eight grid launches in one call): (dx, (LN1(x), o_pre, dqkv) operand
    rows, partial rows [db_qkv | db_proj | dLN1 w | dLN1 b])."""
    dh1 = _check_bwd_args(x, dh1, p, torch.float32)
    B, Np, C = x.shape
    n_real = Np if n_real is None else n_real
    if not 0 < n_real <= Np:
        raise ValueError(f"n_real {n_real} outside (0, {Np}]")
    plan = vit_plan.attn_bwd_f32_plan(B, Np, C, p.heads)
    _check_aligned(x, dh1, p.w_qkv, p.w_proj)
    n = B * Np
    e = lambda *shape: torch.empty(*shape, dtype=torch.float32, device=x.device)
    h_g, opre_g, dqkv_g = e(n, C), e(n, C), e(n, 3 * C)
    part = e(plan.part_rows, plan.part_cols)
    # scratch: [q | k | v] rows, do, the query rows' statistics, dh, W_proj^T, W_qkv^T
    qkv_ws, do_ws, stats_ws, d_ws = e(n, 3 * C), e(n, C), e(*plan.stats_shape), e(n, C)
    wpt_ws, wqt_ws = e(C, C), e(C, 3 * C)
    dx = torch.empty_like(x)
    rc = _lib().vit_attn_bwd_f32_launch(
        _ptr(x), _ptr(dh1), _ptr(dx), _ptr(p.w_qkv), _ptr(p.b_qkv), _ptr(p.w_proj),
        _ptr(p.ln1_w), _ptr(p.ln1_b), _ptr(h_g), _ptr(opre_g), _ptr(dqkv_g), _ptr(part),
        _ptr(qkv_ws), _ptr(do_ws), _ptr(stats_ws), _ptr(d_ws), _ptr(wpt_ws), _ptr(wqt_ws),
        B, Np, C, p.heads, n_real, plan.grid, vit_plan.F32_ATTN_THREADS, plan.query_smem_bytes,
        plan.key_smem_bytes, F32_TILE_ROWS, F32_TILE_COLS, F32_THREADS, plan.qkv.smem_bytes,
        F32_ROW_THREADS, LN_EPS, _cuda_stream(x),
    )
    _check_launch("vit_attn_bwd_f32", rc)
    vit_attn_bwd_f32.launches += 1
    return dx, (h_g, opre_g, dqkv_g), part


def vit_attn_bwd_f32(
    x: torch.Tensor, dh1: torch.Tensor, p: VitBlockParams, n_real: Optional[int] = None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Backward of the attention half in float32 (x, dh1 and p float32; see
    vit_attn_bwd_ref for the math): csrc/vit_attn_bwd_f32.cu, swin_reduce
    and swin_wgrad_f32 on a card, the plain version on the CPU."""
    if x.device.type == "cpu":
        return vit_attn_bwd_ref(x, dh1, p, n_real)
    dx, (h_g, opre_g, dqkv_g), part = vit_attn_bwd_f32_launch(x, dh1, p, n_real)
    C = x.shape[-1]
    dbqkv, dbproj, dln1w, dln1b = swin_reduce(part).split([3 * C, C, C, C])
    return dx, {
        "ln1_w": dln1w, "ln1_b": dln1b,
        "w_qkv": swin_wgrad_f32(dqkv_g, h_g), "b_qkv": dbqkv,
        "w_proj": swin_wgrad_f32(dh1.reshape(-1, C), opre_g), "b_proj": dbproj,
    }


vit_mlp_bwd.launches = 0
vit_attn_bwd.launches = 0
vit_mlp_bwd_f32.launches = 0
vit_attn_bwd_f32.launches = 0
COUNTED = [vit_attn_bwd, vit_mlp_bwd, vit_attn_bwd_f32, vit_mlp_bwd_f32]


def launch_counts() -> dict:
    """Launches of the ViT backward kernels since the last reset (the
    weight products and reductions count in ops.swin.launch_counts)."""
    return {f.__name__: f.launches for f in COUNTED}


def reset_launch_counts() -> None:
    for f in COUNTED:
        f.launches = 0


# ---------------------------------------------------------------------------
# the training block
# ---------------------------------------------------------------------------

_FIELDS = (
    "ln1_w", "ln1_b", "w_qkv", "b_qkv", "w_proj", "b_proj",
    "ln2_w", "ln2_b", "w_fc1", "b_fc1", "w_fc2", "b_fc2",
)


class _VitBlockTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n_real, plain, heads, *weights):
        p = VitBlockParams(heads, **dict(zip(_FIELDS, weights)))
        if plain:
            h1 = vit.vit_attn_ref(x, p, n_real)
            y = vit.vit_mlp_ref(h1, p)
        else:
            h1 = vit.vit_proj(vit.vit_attn(vit.vit_qkv(x, p), p, n_real), x, p)
            y = vit.vit_mlp(h1, p)
        ctx.save_for_backward(x, h1, *weights)
        ctx.meta = (n_real, plain, heads)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, h1, *weights = ctx.saved_tensors
        n_real, plain, heads = ctx.meta
        p = VitBlockParams(heads, **dict(zip(_FIELDS, weights)))
        dy = dy.contiguous()
        if plain:
            dh1, gm = vit_mlp_bwd_ref(h1, dy, p)
            dx, ga = vit_attn_bwd_ref(x, dh1, p, n_real)
        else:
            dh1, gm = vit_mlp_bwd(h1, dy, p)
            dx, ga = vit_attn_bwd(x, dh1, p, n_real)
        g = {**gm, **ga}
        # each gradient in its weight's dtype: the bf16 matrices' gradients
        # round to bf16 here, as at the JAX custom_vjp boundary
        grads = [g[f].to(w.dtype) for f, w in zip(_FIELDS, weights)]
        return (dx, None, None, None, *grads)


def fused_vit_block_train(
    x: torch.Tensor,
    p: VitBlockParams,
    n_real: Optional[int] = None,
    impl: str = "kernel",
) -> torch.Tensor:
    """Differentiable ViT block on tokens x (B, Np, C), Np a multiple of 16
    (ops.vit.pad_tokens); n_real < Np masks the padded key columns, and the
    caller uses y[:, :n_real] only. p: the block's kernel layout built inside
    autograd (ops.vit.vit_block_layout), so gradients reach the float32
    parameters. impl: "kernel" (CUDA kernels for CUDA tensors, plain versions
    on the CPU), "plain" (the plain versions with their explicit backward on
    any device), "autograd" (the plain forward differentiated by torch
    autograd)."""
    Np = x.shape[1]
    if n_real is not None and n_real >= Np:
        n_real = None
    if impl == "autograd":
        return vit.vit_mlp_ref(vit.vit_attn_ref(x, p, n_real), p)
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel', 'plain' or 'autograd', got {impl!r}")
    weights = [getattr(p, f) for f in _FIELDS]
    return _VitBlockTrain.apply(x, n_real, impl == "plain", p.heads, *weights)
