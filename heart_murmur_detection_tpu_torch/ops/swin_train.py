"""Training swin block for HTS-AT: the counterpart of
heart_murmur_detection_tpu/ops/pallas_swin_train.py::fused_swin_block_train
(TPU K8, :606) as a torch.autograd.Function over hand-written CUDA kernels.

  forward    h1 = x + k1 * attn(x), y = h1 + k2 * mlp(h1): the eval kernels
             swin_attn / swin_mlp of ops/swin.py with a per-sample branch
             multiplier (the TPU body `_train_fwd_kernel` :233); saves (x, h1)
  backward   swin_mlp_bwd  (h1, dy) -> dh1 + per-token operands + per-block
                           column sums          (TPU body `_bwd_mlp_kernel` :271)
             swin_attn_bwd (x, dh1) -> dx + per-token operands + per-block
                           column sums and rel-pos bias sums
                                                (TPU body `_bwd_attn_kernel` :320)
             swin_wgrad    the weight gradients dW = A^T B over tokens in one
                           launch: split over fixed token chunks, the chunks'
                           float32 partials summed in chunk order
             swin_reduce   sums the per-block column-sum rows in block order

The TPU kernels accumulate weight gradients in a VMEM block that stays
resident across their sequential grid. CUDA blocks run in no order, so here
nothing is summed with atomics: the backward kernels emit the per-token
operands of each weight product (LN(x), o_pre, dqkv, k1 dh1; LN2(h1), gelu(a1),
k2 dy, da1) and their per-block column sums, swin_wgrad multiplies the
operands over fixed token chunks and sums the chunks' partials in chunk
order in the same launch, and swin_reduce adds the column-sum rows in block
order. Two runs on the same inputs give bitwise-equal gradients.

DropPath enters as per-sample keep multipliers k1, k2 (B,) float32 in
{0, 1/keep}. The cyclic shift of a shifted block lives in the addressing of
both directions (the JAX path rolls outside); mask (nW, N, N) is indexed in
the rolled frame.

Rounding (bfloat16 activations and weights, float32 accumulation, LN,
softmax and GELU): the forward rounds where the eval kernels round (qkv, the
scaled q with a bf16 scale constant, the attention output, h1, the GELU
output, y). The backward rounds each product operand to bf16 (dy k2, da1,
dw = k1 dh1, do, P, ds, dq/dk/dv) and keeps every elementwise step, every
column sum and every weight-gradient accumulation in float32; the weight
gradients of the bf16 matrices are rounded to bf16 at the Function's
boundary, as the JAX custom_vjp does (:594-597). The plain versions below
round at the same points, so in float32 they are the exact gradient of the
plain forward.

Dispatch: a CPU tensor runs the plain version; a CUDA bfloat16 tensor
launches the kernels; any other CUDA dtype raises. impl="plain" runs the
plain versions on any device; impl="autograd" differentiates the plain
forward with torch autograd (the strict float32 path).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import swin
from .swin import (
    HDP,
    WINDOW,
    SwinBlockParams,
    _check_cuda_args,
    _check_launch,
    _cuda_stream,
    _mmf,
    _ptr,
)

_SQRT1_2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327
TOKEN_TILE = 64  # tokens a swin_mlp_bwd tile, and rows of a swin_wgrad chunk step
TARGET_BLOCKS = 512  # backward blocks a launch aims for (partials per launch)
WGRAD_TILE = 128  # swin_wgrad output tile columns (rows: wgrad_tile_rows)
# swin_wgrad's split cost model (wgrad_split): blocks a wave, one an SM of an
# H100 (a second resident block shares its SM's throughput), and a chunk's
# fixed cost (its partial tile written and summed, the pipeline's fill) in
# 64-token steps; the pair that measured fastest over a COLA and an
# Audio-MAE step's products (bench/wgrad_time.py shapes, PERF.md)
WGRAD_BLOCKS = 132
WGRAD_STEP_COST = 16
WGRAD_ONE_LEVEL = 8  # chunks summed by one last block; past it, two levels


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _ln_stats(x: torch.Tensor, eps: float = 1e-5):
    """float32 (xhat, rstd) of LayerNorm over the last axis."""
    x = x.to(torch.float32)
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (x - mu) * rstd, rstd


def _ln_bwd_input(dh, xhat, rstd, w):
    """dL/dx of LayerNorm from dL/d(out) (pallas_swin_train._ln_bwd_input)."""
    dxhat = dh * w
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return rstd * (dxhat - m1 - xhat * m2)


def gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the exact GELU: Phi(x) + x phi(x) (pallas_swin_train._gelu_grad)."""
    return 0.5 * (1.0 + torch.erf(x * _SQRT1_2)) + x * torch.exp(-0.5 * x * x) * _INV_SQRT_2PI


def _windows(t: torch.Tensor, window: int) -> torch.Tensor:
    B, H, W, C = t.shape
    return (
        t.reshape(B, H // window, window, W // window, window, C)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(-1, window * window, C)
    )


def _unwindows(t: torch.Tensor, B: int, H: int, W: int, window: int) -> torch.Tensor:
    C = t.shape[-1]
    return (
        t.reshape(B, H // window, W // window, window, window, C)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(B, H, W, C)
    )


def swin_mlp_bwd_ref(
    h1: torch.Tensor,
    dy: torch.Tensor,
    k2: Optional[torch.Tensor],
    p: SwinBlockParams,
    eps: float = 1e-5,
    rows: bool = False,
):
    """Plain version of swin_mlp_bwd: y = h1 + k2 mlp(LN2(h1)), given dy ->
    (dh1 in h1's dtype, float32 gradients of ln2_w, ln2_b, w_fc1, b_fc1,
    w_fc2, b_fc2 in the torch (out, in) layout). k2=None is no multiplier;
    p may be any block layout with the MLP fields (ops.vit.VitBlockParams
    too, with the ViT's LN eps 1e-6). rows=True also returns the operand
    rows (LN2(h1), GELU(a1), da1) rounded as the kernel emits them."""
    act, mm = h1.dtype, p.mm_dtype
    B, C = h1.shape[0], h1.shape[-1]
    xhat, rstd = _ln_stats(h1.reshape(-1, C), eps)
    mb = _mmf(xhat * p.ln2_w + p.ln2_b, mm)
    a1 = mb @ _mmf(p.w_fc1, mm).T + p.b_fc1
    dyf = dy.reshape(-1, C).to(torch.float32)
    dyk = dyf if k2 is None else k2.reshape(B, 1).repeat_interleave(dyf.shape[0] // B, 0) * dyf
    dykb = _mmf(dyk, mm)
    gb = _mmf(F.gelu(a1, approximate="none"), mm)
    da1 = (dykb @ _mmf(p.w_fc2, mm)) * gelu_grad(a1)
    da1b = _mmf(da1, mm)
    dm = da1b @ _mmf(p.w_fc1, mm)
    dh1 = (dyf + _ln_bwd_input(dm, xhat, rstd, p.ln2_w)).to(act).reshape(h1.shape)
    grads = {
        "ln2_w": (dm * xhat).sum(0),
        "ln2_b": dm.sum(0),
        "w_fc1": da1b.T @ mb,
        "b_fc1": da1.sum(0),
        "w_fc2": dykb.T @ gb,
        "b_fc2": dyk.sum(0),
    }
    return (dh1, grads, (mb, gb, da1b)) if rows else (dh1, grads)


def swin_attn_bwd_ref(
    x: torch.Tensor,
    dh1: torch.Tensor,
    k1: torch.Tensor,
    p: SwinBlockParams,
    mask: Optional[torch.Tensor] = None,
    shift: int = 0,
    window: int = WINDOW,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain version of swin_attn_bwd: h1 = x + k1 attn(x), given dh1 ->
    (dx in x's dtype, float32 gradients of ln1_w, ln1_b, w_qkv and b_qkv in
    the padded layout, w_proj, b_proj and the gathered bias (heads, N, N))."""
    act, mm = x.dtype, p.mm_dtype
    B, H, W, C = x.shape
    heads, hd, hdp = p.heads, p.hd, p.hdp
    N = window * window
    Cp = heads * hdp
    roll = lambda t, s: torch.roll(t, (s, s), (1, 2)) if shift else t
    xw = _windows(roll(x, -shift), window)
    dhw = _windows(roll(dh1, -shift), window).to(torch.float32)
    Bn = xw.shape[0]
    xhat, rstd = _ln_stats(xw)
    hb = _mmf(xhat * p.ln1_w + p.ln1_b, mm)
    # recompute the forward: q, k, v, P and the attention output
    qkv = (hb @ _mmf(p.w_qkv, mm).T + p.b_qkv).to(act)
    qkv = qkv.reshape(Bn, N, 3, heads, hdp).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (Bn, heads, N, hdp)
    qscale = torch.tensor(hd**-0.5, dtype=act, device=x.device)
    qs = q * qscale
    a = _mmf(qs, mm) @ _mmf(k, mm).transpose(-1, -2) + p.bias
    if mask is not None:
        a = (a.reshape(B, -1, heads, N, N) + mask[None, :, None]).reshape(Bn, heads, N, N)
    pr = torch.softmax(a, -1)
    pb, vb = _mmf(pr, mm), _mmf(v, mm)
    o_pre = _mmf((pb @ vb)[..., :hd].permute(0, 2, 1, 3).reshape(Bn * N, C), mm)
    # proj and its input
    dwf = k1.reshape(B, 1, 1).repeat_interleave(Bn // B, 0) * dhw
    dwb = _mmf(dwf.reshape(-1, C), mm)
    do = _mmf(dwb @ _mmf(p.w_proj, mm), mm).reshape(Bn, N, heads, hd).permute(0, 2, 1, 3)
    dost = F.pad(do, (0, hdp - hd))  # (Bn, heads, N, hdp), zero padded columns
    # softmax and q/k/v
    dp = dost @ vb.transpose(-1, -2)
    dv = pb.transpose(-1, -2) @ dost
    ds = pr * (dp - (dp * pr).sum(-1, keepdim=True))
    dsb = _mmf(ds, mm)
    dq = (dsb @ _mmf(k, mm)) * qscale.to(torch.float32)
    dk = dsb.transpose(-1, -2) @ _mmf(qs, mm)
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(Bn * N, 3 * Cp)
    dqkvb = _mmf(dqkv, mm)
    dh = dqkvb @ _mmf(p.w_qkv, mm)
    xh = xhat.reshape(-1, C)
    dxw = _ln_bwd_input(dh, xh, rstd.reshape(-1, 1), p.ln1_w).reshape(Bn, N, C)
    dx = roll(_unwindows((dhw + dxw).to(act), B, H, W, window), shift)
    return dx, {
        "ln1_w": (dh * xh).sum(0),
        "ln1_b": dh.sum(0),
        "w_qkv": dqkvb.T @ hb.reshape(-1, C),
        "b_qkv": dqkv.sum(0),
        "w_proj": dwb.T @ o_pre,
        "b_proj": dwf.reshape(-1, C).sum(0),
        "bias": ds.sum(0),
    }


def wgrad_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of swin_wgrad: a (n, M), b (n, N) -> a^T b (M, N) float32."""
    return a.to(torch.float32).T @ b.to(torch.float32)


def reduce_ref(parts: torch.Tensor) -> torch.Tensor:
    """Plain version of swin_reduce: (S, L) float32 -> (L,), summed in row order."""
    out = parts[0].clone()
    for i in range(1, parts.shape[0]):
        out += parts[i]
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _lib():
    from . import _build

    return _build.load_library()


def _blocks_for(units: int) -> Tuple[int, int]:
    """(units a block, blocks) of a backward launch: about TARGET_BLOCKS
    blocks, each a contiguous run of units, fixed by the shapes alone."""
    per = max(1, units // TARGET_BLOCKS)
    return per, -(-units // per)


@functools.lru_cache(maxsize=None)
def wgrad_split(n: int, M: int, N: int) -> Tuple[int, int]:
    """(chunks S, tokens a chunk) of swin_wgrad for an (n, M) x (n, N)
    product, fixed by the shapes alone. Blocks of output tiles
    (wgrad_tile_rows x 128) run WGRAD_BLOCKS at a time, so S chunks take
    ceil(S tiles / WGRAD_BLOCKS) waves of one chunk's time each, a chunk
    costing its 64-token steps plus WGRAD_STEP_COST when there is more than
    one; S minimises that. Chunk s holds tokens [s chunk, min(n, (s + 1)
    chunk)), a multiple of 64 each."""
    tiles = -(-M // wgrad_tile_rows(M)) * -(-N // WGRAD_TILE)
    steps = n // TOKEN_TILE

    def cost(S: int) -> int:
        per = -(-steps // S)  # steps a chunk
        chunks = -(-steps // per)
        waves = -(-chunks * tiles // WGRAD_BLOCKS)
        return waves * (per + (WGRAD_STEP_COST if chunks > 1 else 0))

    chunk = -(-steps // min(range(1, steps + 1), key=cost)) * TOKEN_TILE
    return -(-n // chunk), chunk


def wgrad_tile_rows(M: int) -> int:
    """Rows of swin_wgrad's output tile: 256 for products of 512 or more
    rows (a tile reads B once for twice the rows), else 128."""
    return 256 if M >= 512 else 128


def wgrad_group(S: int) -> int:
    """Chunks in a first-level group of swin_wgrad's ordered sum: all S up
    to WGRAD_ONE_LEVEL (one level: the last block reads S partial tiles),
    else about sqrt(S), so the last block of a group and the last group
    each read about sqrt(S)."""
    return S if S <= WGRAD_ONE_LEVEL else math.ceil(math.sqrt(S))


def swin_wgrad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T b over the token axis: a (n, M), b (n, N) bf16 -> (M, N) float32,
    one launch: split over the token chunks of wgrad_split, their partials
    summed in chunk order within groups of wgrad_group, then the group sums
    in group order."""
    if a.device.type == "cpu":
        return wgrad_ref(a, b)
    a, b = a.contiguous(), b.contiguous()
    n, M = a.shape
    Nn = b.shape[1]
    if (a.dtype, b.dtype) != (torch.bfloat16, torch.bfloat16) or b.shape[0] != n:
        raise TypeError("swin_wgrad takes two bfloat16 (n, *) operands")
    if n % TOKEN_TILE or M % 32 or Nn % 32:
        raise ValueError(f"swin_wgrad takes n a multiple of 64 and widths multiples of 32, "
                         f"got {tuple(a.shape)} x {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError("swin_wgrad takes two tensors on one card")
    S, chunk = wgrad_split(n, M, Nn)
    group = wgrad_group(S)
    G = -(-S // group)
    rows = wgrad_tile_rows(M)
    tiles = -(-M // rows) * -(-Nn // WGRAD_TILE)
    out = torch.empty(M, Nn, dtype=torch.float32, device=a.device)
    ws = cnt = None
    if S > 1:  # the partial tiles, the group sums, and the arrival counters
        ws = torch.empty((S + (G if G > 1 else 0)) * tiles * rows * WGRAD_TILE,
                         dtype=torch.float32, device=a.device)
        cnt = torch.zeros(tiles * (G + 1), dtype=torch.int32, device=a.device)
    rc = _lib().swin_wgrad_launch(
        _ptr(a), _ptr(b), _ptr(out), _ptr(ws), _ptr(cnt), n, M, Nn, chunk, group, rows,
        _cuda_stream(a),
    )
    _check_launch("swin_wgrad", rc)
    swin_wgrad.launches += 1
    return out


def swin_reduce(parts: torch.Tensor) -> torch.Tensor:
    """Sum float32 partials (S, L) over S in row order -> (L,)."""
    if parts.device.type == "cpu":
        return reduce_ref(parts)
    if parts.dtype != torch.float32 or parts.dim() != 2 or not parts.is_contiguous():
        raise TypeError("swin_reduce takes contiguous float32 (S, L) partials")
    S, L = parts.shape
    out = torch.empty(L, dtype=torch.float32, device=parts.device)
    rc = _lib().swin_reduce_launch(_ptr(parts), _ptr(out), S, L, _cuda_stream(parts))
    _check_launch("swin_reduce", rc)
    swin_reduce.launches += 1
    return out


def _check_bwd_args(x, g, k, p):
    _check_cuda_args(x, p, WINDOW)
    if x.shape[-1] > 384:
        raise ValueError("the backward kernels take C <= 384 (stage 3 trains as a plain block)")
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("the incoming gradient must match the activation")
    if (x.shape[0] * x.shape[1] * x.shape[2]) % TOKEN_TILE:
        raise ValueError("token count must be a multiple of 64")
    if k is None:
        raise ValueError("the backward kernels take the per-sample multipliers")
    return g.contiguous(), swin._check_kmul(k, x)


def swin_mlp_bwd_launch(h1, dy, k2, p: SwinBlockParams):
    """The swin_mlp_bwd launch on CUDA tensors: (dh1, (LN2(h1), GELU(a1),
    k2 dy, da1) operand rows, per-block partial rows [db1 | db2 | dLN2 w |
    dLN2 b])."""
    dy, k2 = _check_bwd_args(h1, dy, k2, p)
    B, H, W, C = h1.shape
    n, hidden = B * H * W, p.w_fc1.shape[0]
    tpb, G = _blocks_for(n // TOKEN_TILE)
    e = lambda cols: torch.empty(n, cols, dtype=h1.dtype, device=h1.device)
    m_g, g_g, dyk_g, da1_g = e(C), e(hidden), e(C), e(hidden)
    part = torch.empty(G, hidden + 3 * C, dtype=torch.float32, device=h1.device)
    dh1 = torch.empty_like(h1)
    rc = _lib().swin_mlp_bwd_launch(
        _ptr(h1), _ptr(dy), _ptr(k2), _ptr(dh1), _ptr(p.ln2_w), _ptr(p.ln2_b),
        _ptr(p.w_fc1), _ptr(p.b_fc1), _ptr(p.w_fc2),
        _ptr(m_g), _ptr(g_g), _ptr(dyk_g), _ptr(da1_g), _ptr(part),
        n, C, hidden, H * W, tpb, 1e-5, _cuda_stream(h1),
    )
    _check_launch("swin_mlp_bwd", rc)
    swin_mlp_bwd.launches += 1
    return dh1, (m_g, g_g, dyk_g, da1_g), part


def swin_mlp_bwd(
    h1: torch.Tensor, dy: torch.Tensor, k2: torch.Tensor, p: SwinBlockParams
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Backward of the MLP half (see swin_mlp_bwd_ref for the math)."""
    if h1.device.type == "cpu":
        return swin_mlp_bwd_ref(h1, dy, k2, p)
    dh1, (m_g, g_g, dyk_g, da1_g), part = swin_mlp_bwd_launch(h1, dy, k2, p)
    C, hidden = h1.shape[-1], p.w_fc1.shape[0]
    db1, db2, dln2w, dln2b = swin_reduce(part).split([hidden, C, C, C])
    return dh1, {
        "ln2_w": dln2w, "ln2_b": dln2b,
        "w_fc1": swin_wgrad(da1_g, m_g), "b_fc1": db1,
        "w_fc2": swin_wgrad(dyk_g, g_g), "b_fc2": db2,
    }


def swin_attn_bwd_launch(x, dh1, k1, p: SwinBlockParams, mask=None, shift: int = 0):
    """The swin_attn_bwd launch on CUDA tensors: (dx, (LN1(x), k1 dh1, o_pre,
    dqkv) operand rows, per-block partial rows [dbias | db_qkv | db_proj |
    dLN1 w | dLN1 b])."""
    dh1, k1 = _check_bwd_args(x, dh1, k1, p)
    B, H, W, C = x.shape
    nw = (H // WINDOW) * (W // WINDOW)
    if mask is not None:
        if mask.dtype != torch.float32 or tuple(mask.shape) != (nw, 64, 64):
            raise ValueError("mask must be float32 (nW, 64, 64)")
        mask = mask.contiguous()
    heads = p.heads
    n, Cp3 = B * H * W, 3 * heads * HDP
    wpb, G = _blocks_for(B * nw)
    e = lambda cols: torch.empty(n, cols, dtype=x.dtype, device=x.device)
    h_g, dw_g, opre_g, dqkv_g = e(C), e(C), e(C), e(Cp3)
    part = torch.empty(G, heads * 64 * 64 + Cp3 + 3 * C, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    rc = _lib().swin_attn_bwd_launch(
        _ptr(x), _ptr(dh1), _ptr(k1), _ptr(dx), _ptr(p.w_qkv), _ptr(p.b_qkv),
        _ptr(p.w_proj), _ptr(p.ln1_w), _ptr(p.ln1_b), _ptr(p.bias), _ptr(mask),
        _ptr(h_g), _ptr(dw_g), _ptr(opre_g), _ptr(dqkv_g), _ptr(part),
        B, H, W, C, heads, shift, wpb, _cuda_stream(x),
    )
    _check_launch("swin_attn_bwd", rc)
    swin_attn_bwd.launches += 1
    return dx, (h_g, dw_g, opre_g, dqkv_g), part


def swin_attn_bwd(
    x: torch.Tensor,
    dh1: torch.Tensor,
    k1: torch.Tensor,
    p: SwinBlockParams,
    mask: Optional[torch.Tensor] = None,
    shift: int = 0,
    window: int = WINDOW,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Backward of the attention half (see swin_attn_bwd_ref for the math)."""
    if x.device.type == "cpu":
        return swin_attn_bwd_ref(x, dh1, k1, p, mask, shift, window)
    if window != WINDOW:
        raise ValueError(f"the kernels take window {WINDOW}, got {window}")
    dx, (h_g, dw_g, opre_g, dqkv_g), part = swin_attn_bwd_launch(x, dh1, k1, p, mask, shift)
    C, heads = x.shape[-1], p.heads
    nb, Cp3 = heads * 64 * 64, 3 * heads * HDP
    dbias, dbqkv, dbproj, dln1w, dln1b = swin_reduce(part).split([nb, Cp3, C, C, C])
    return dx, {
        "ln1_w": dln1w, "ln1_b": dln1b,
        "w_qkv": swin_wgrad(dqkv_g, h_g), "b_qkv": dbqkv,
        "w_proj": swin_wgrad(dw_g, opre_g), "b_proj": dbproj,
        "bias": dbias.reshape(heads, 64, 64),
    }


swin_mlp_bwd.launches = 0
swin_attn_bwd.launches = 0
swin_wgrad.launches = 0
swin_reduce.launches = 0
swin.COUNTED.extend((swin_attn_bwd, swin_mlp_bwd, swin_wgrad, swin_reduce))


# ---------------------------------------------------------------------------
# the training block
# ---------------------------------------------------------------------------

_FIELDS = (
    "ln1_w", "ln1_b", "w_qkv", "b_qkv", "w_proj", "b_proj", "bias",
    "ln2_w", "ln2_b", "w_fc1", "b_fc1", "w_fc2", "b_fc2",
)


def _window(p: SwinBlockParams) -> int:
    """The window side of a block, from its gathered bias (heads, N, N)."""
    return math.isqrt(p.bias.shape[-1])


class _SwinBlockTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k1, k2, mask, shift, plain, heads, hd, *weights):
        p = SwinBlockParams(heads, hd, **dict(zip(_FIELDS, weights)))
        if plain:
            h1 = swin.swin_attn_ref(x, p, mask, shift, window=_window(p), kmul=k1)
            y = swin.swin_mlp_ref(h1, p, k2)
        else:
            h1 = swin.swin_attn(x, p, mask, shift, window=_window(p), kmul=k1)
            y = swin.swin_mlp(h1, p, k2)
        ctx.save_for_backward(x, h1, k1, k2, mask, *weights)
        ctx.meta = (shift, plain, heads, hd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, h1, k1, k2, mask, *weights = ctx.saved_tensors
        shift, plain, heads, hd = ctx.meta
        p = SwinBlockParams(heads, hd, **dict(zip(_FIELDS, weights)))
        dy = dy.contiguous()
        if plain:
            dh1, gm = swin_mlp_bwd_ref(h1, dy, k2, p)
            dx, ga = swin_attn_bwd_ref(x, dh1, k1, p, mask, shift, _window(p))
        else:
            dh1, gm = swin_mlp_bwd(h1, dy, k2, p)
            dx, ga = swin_attn_bwd(x, dh1, k1, p, mask, shift, _window(p))
        g = {**gm, **ga}
        # each gradient in its weight's dtype: the bf16 matrices' gradients
        # round to bf16 here, as at the JAX custom_vjp boundary
        grads = [g[f].to(w.dtype) for f, w in zip(_FIELDS, weights)]
        return (dx, None, None, None, None, None, None, None, *grads)


def fused_swin_block_train(
    x: torch.Tensor,
    p: SwinBlockParams,
    mask: Optional[torch.Tensor],
    shift: int,
    k1: torch.Tensor,
    k2: torch.Tensor,
    impl: str = "kernel",
) -> torch.Tensor:
    """Differentiable swin block on spatial x (B, H, W, C) with DropPath keep
    multipliers k1, k2 (B,) float32: y = h1 + k2 mlp(h1), h1 = x + k1 attn(x).

    p: the block's kernel layout built inside autograd
    (ops.swin.block_layout), so gradients reach the float32 parameters.
    shift > 0 is a shifted block; mask its (nW, N, N) mask. impl: "kernel"
    (CUDA kernels for CUDA tensors, plain versions on the CPU), "plain" (the
    plain versions with their explicit backward on any device), "autograd"
    (the plain forward differentiated by torch autograd)."""
    k1 = k1.reshape(-1).to(torch.float32)
    k2 = k2.reshape(-1).to(torch.float32)
    if impl == "autograd":
        h1 = swin.swin_attn_ref(x, p, mask, shift, window=_window(p), kmul=k1)
        return swin.swin_mlp_ref(h1, p, k2)
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel', 'plain' or 'autograd', got {impl!r}")
    weights = [getattr(p, f) for f in _FIELDS]
    return _SwinBlockTrain.apply(
        x, k1, k2, mask, shift, impl == "plain", p.heads, p.hd, *weights
    )


# ---------------------------------------------------------------------------
# the relative-position bias gather with a fixed-order backward
# ---------------------------------------------------------------------------


class _BiasGather(torch.autograd.Function):
    """table[idx] whose backward sums each table row's positions in a fixed
    order (a padded segment sum), not with scatter-add atomics."""

    @staticmethod
    def forward(ctx, table, idx, seg):
        ctx.save_for_backward(seg)
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (seg,) = ctx.saved_tensors
        gz = torch.cat([g, g.new_zeros(1, g.shape[1])])  # row -1 pads segments
        return gz[seg].sum(1), None, None


def bias_segments(idx) -> torch.Tensor:
    """For rel_pos_bias: (T, K) positions of each table row in idx (N*N,),
    in position order, padded with N*N (a zero row). Built once a window."""
    import numpy as np

    idx = np.asarray(idx).reshape(-1)
    rows = [np.flatnonzero(idx == t) for t in range(int(idx.max()) + 1)]
    K = max(len(r) for r in rows)
    seg = np.full((len(rows), K), idx.size, np.int64)
    for t, r in enumerate(rows):
        seg[t, : len(r)] = r
    return torch.from_numpy(seg)


def rel_pos_bias(table: torch.Tensor, idx: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Gather the (T, heads) relative-position table at idx (N*N,) ->
    (heads, N, N), differentiable with a deterministic backward; seg is
    bias_segments(idx) on the table's device."""
    N = math.isqrt(idx.numel())
    return _BiasGather.apply(table, idx, seg).reshape(N, N, -1).permute(2, 0, 1)
