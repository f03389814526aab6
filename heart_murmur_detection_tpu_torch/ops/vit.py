"""ViT blocks for the MAE encoders (operaGT ViT-S, Audio-MAE ViT-B) and
HeAR's ViT-L (C 1024, 16 heads, 97 tokens padded to 112): four hand-written
CUDA kernels, their plain torch versions, and the three eval entry points of
heart_murmur_detection_tpu/ops/pallas_vit.py built from them.

  vit_qkv   LN1 -> qkv (q pre-scaled by 1/sqrt(hd)), written head-major,
            and on request LN1(x) itself (csrc/vit_qkv.cu, LN1 once a token
            and the product on wgmma; the first part of the TPU body
            `_attn_half`, and the recompute that vit_attn_bwd launches; at
            C 1024 csrc/vit_rows.cu: an LN1 row pass, then a GEMM)
  vit_attn  per head softmax(q k^T, padded keys masked) v, each head's
            output rounded to bf16 in its column block of o_pre
            (csrc/vit_attn.cu; the attention of `_attn_half`), or one of the
            attention modes of the TPU attention-half kernels K10
            (bench/gt_attn_opt.py::kernel) and K11
            (bench/vit_attn_ablate.py::attn_kernel), see ATTN_MODES
  vit_proj  o_pre -> proj -> + b_proj + x (csrc/vit_proj.cu; the rest of
            `_attn_half`)
  vit_mlp   LN2 -> fc1 -> exact GELU -> fc2 -> +x, token-wise
            (csrc/swin_mlp.cu with LN eps 1e-6; at C 1024 csrc/vit_rows.cu:
            an LN2 row pass, fc1 + GELU and fc2 + residual GEMMs; the TPU
            body `_mlp_half`)

  fused_vit_block  vit_qkv, vit_attn, vit_proj, vit_mlp  (TPU K5, :296)
  fused_vit_attn   vit_qkv, vit_attn, vit_proj           (TPU K6, :341)
  fused_vit_mlp    vit_mlp                               (TPU K7, :373)

The TPU kernels kept the whole sequence in VMEM; on Hopper K and V of one
head (1040 x 64 x 2 x 2 B) stream through shared memory in 64-key tiles,
one block for each (clip, head, 128 query rows), with the scores kept in
registers; the qkv product is its own launch that writes q, k and v once
to device memory, and proj its own launch that reads the head outputs
o_pre once (vit_attn and vit_proj launch as a pair on every path).

Sequence padding as the JAX package: callers pad tokens to a multiple of 16
(pad_tokens) and pass the real count n_real; key columns >= n_real get
-1e9 (exp underflows to an exact zero), padded query rows produce garbage
that stays in padded rows and is sliced off after the stack.

Attention modes (`mode` of vit_attn, its plain versions and the entry
points; the extraction flow's fast_softmax picks between the first two):
  stable         softmax(s) with the row max, P rounded after normalising
  fast           e = exp(s) (no row max), P = bf16(e), P v times 1 / sum(e)
  norm_before    e = exp(s) (no row max), P = bf16(e / sum(e)), P v
  bf16_exp       e = exp(bf16(s)) in float32, P = bf16(e), P v times
                 1 / sum(e): the exp of a bf16 score as XLA computes K10's v5
                 (jnp.exp of the bf16 s, whose float32 sum XLA takes over
                 the unrounded exp and whose product operand it rounds)
  no_softmax     P = bf16(s) (padded keys give P = 0), P v
  q_passthrough  o = q: the attention output is the q third of qkv
  aligned_hcat   head h reads q, k and v at columns off + (h 128) mod 2C of
                 the (B, Np, 3C) qkv (off 0, C, 2C), then norm_before; a
                 ValueError wherever a slice runs past 3C (at head dim 64
                 with two or more heads, always)
K10's modes v0, v1, v2 and K11's full are norm_before; v3 and v4 fast; v5
bf16_exp; K11's no_softmax no_softmax; K10's noattn and K11's no_attn and
ident q_passthrough (bench/attn_ablate.py JAX_MODES). K10 and K11 feed q unscaled:
vit_block_layout(..., qk_scale=1.0).

Dispatch: a CPU tensor runs the plain version; a CUDA bfloat16 tensor
launches the kernel; any other CUDA dtype raises. `impl="plain"` asks for
the plain version on any device (the tests and the on-card reference). The
plain versions round where the TPU body rounds: LN1 / LN2 (eps 1e-6, f32
statistics) to the activation dtype, qkv after its bias, P to the matmul
dtype for the P v product (normalised first, or, in the fast modes,
unnormalised with P v scaled by 1/sum after), the attention output, the
GELU output, and the residual sums once.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from . import vit_plan
from .swin import (_check_aligned, _check_launch, _cuda_stream, _ln, _mlp_launch, _mmf, _ptr,
                   sm_count)
from .swin_plan import MLP_WIDTHS

LN_EPS = 1e-6
HD = 64  # the kernels' head dim (ViT-S/16, ViT-B/16 and ViT-L/16 all use 64)
# the widths of the attention kernels: ViT-S (operaGT), ViT-B (Audio-MAE) and
# ViT-L (HeAR, 16 heads); the MLP kernels' are swin_plan.MLP_WIDTHS (csrc/swin_mlp.cu)
# and vit_plan.ROWS_WIDTHS (csrc/vit_rows.cu)
ATTN_WIDTHS = (384, 768, 1024)
MASK = -1e9
ATTN_MODES = ("stable", "fast", "norm_before", "bf16_exp", "no_softmax", "q_passthrough",
              "aligned_hcat")
# the kernel's mode numbers (csrc/vit_attn.cu); aligned_hcat runs as
# norm_before where it is defined
_MODE_ID = {m: i for i, m in enumerate(ATTN_MODES[:6])}

@dataclasses.dataclass(frozen=True)
class VitBlockParams:
    """One eval ViT block laid out for the kernels once at weight load (the
    counterpart of pallas_vit._attn_weights / _mlp_weights). Matmul weights
    keep the torch (out, in) layout in the matmul dtype, with 1/sqrt(hd)
    folded into the q rows and the q bias before the cast. LayerNorm
    parameters and biases are float32."""

    heads: int
    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    w_qkv: torch.Tensor  # (3C, C), q rows scaled
    b_qkv: torch.Tensor  # (3C,), q part scaled
    w_proj: torch.Tensor  # (C, C)
    b_proj: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    w_fc1: torch.Tensor  # (hidden, C)
    b_fc1: torch.Tensor
    w_fc2: torch.Tensor  # (C, hidden)
    b_fc2: torch.Tensor

    @property
    def dim(self) -> int:
        return self.w_proj.shape[0]

    @property
    def hd(self) -> int:
        return self.dim // self.heads

    @property
    def hidden(self) -> int:
        return self.w_fc1.shape[0]

    @property
    def mm_dtype(self) -> torch.dtype:
        return self.w_qkv.dtype


def vit_block_layout(get, heads: int, mm_dtype: torch.dtype,
                     qk_scale: Optional[float] = None) -> VitBlockParams:
    """Lay out one block's weights for the kernels with differentiable torch
    ops: `get(name)` returns the float32 tensor of a reference key (norm1.*,
    attn.qkv.*, attn.proj.*, norm2.*, mlp.fc1.*, mlp.fc2.*). The training
    path builds this inside autograd every step, so the gradients of the
    folded bf16 layout flow back to the float32 parameters through the fold
    and the cast (pallas_vit_train._prep_vit_train_weights :680);
    prep_vit_block builds it once, detached, for inference.

    As pallas_vit._attn_weights :222-238: the q rows of w_qkv and the q part
    of b_qkv are multiplied by qk_scale (hd^-0.5 unless given; 1.0 for the
    unscaled q of the K10 / K11 attention halves) in float32 before the
    matmul-dtype cast, so the kernels never scale q."""
    w_qkv, b_qkv = get("attn.qkv.weight"), get("attn.qkv.bias")
    C = w_qkv.shape[1]
    if C % heads:
        raise ValueError(f"{heads} heads must divide C = {C}")
    scale = (C // heads) ** -0.5 if qk_scale is None else qk_scale
    w_qkv = torch.cat([w_qkv[:C] * scale, w_qkv[C:]])
    b_qkv = torch.cat([b_qkv[:C] * scale, b_qkv[C:]])
    mm = lambda t: t.to(mm_dtype).contiguous()
    f32 = lambda k: get(k).contiguous()
    return VitBlockParams(
        heads=heads,
        ln1_w=f32("norm1.weight"),
        ln1_b=f32("norm1.bias"),
        w_qkv=mm(w_qkv),
        b_qkv=b_qkv.contiguous(),
        w_proj=mm(get("attn.proj.weight")),
        b_proj=f32("attn.proj.bias"),
        ln2_w=f32("norm2.weight"),
        ln2_b=f32("norm2.bias"),
        w_fc1=mm(get("mlp.fc1.weight")),
        b_fc1=f32("mlp.fc1.bias"),
        w_fc2=mm(get("mlp.fc2.weight")),
        b_fc2=f32("mlp.fc2.bias"),
    )


def prep_vit_block(
    sd: Mapping[str, torch.Tensor],
    heads: int,
    mm_dtype: torch.dtype,
    device=None,
) -> VitBlockParams:
    """Lay out one block's weights for the kernels, detached, once at weight
    load (vit_block_layout). sd: the block's state_dict under the reference
    key names."""
    return vit_block_layout(
        lambda k: sd[k].detach().to(device=device, dtype=torch.float32), heads, mm_dtype)


def pad_tokens(x: torch.Tensor, multiple: int = 16) -> Tuple[torch.Tensor, int]:
    """Pad (B, N, C) tokens with zeros to a multiple of `multiple`; returns
    (padded, N)."""
    B, N, C = x.shape
    Np = -(-N // multiple) * multiple
    if Np != N:
        x = F.pad(x, (0, 0, 0, Np - N))
    return x, N


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def vit_qkv_ref(x: torch.Tensor, p: VitBlockParams) -> torch.Tensor:
    """Plain version of the vit_qkv kernel: x (B, Np, C) -> q, k, v stacked
    head-major as (3, B, heads, Np, hd) in x's dtype; q carries 1/sqrt(hd)."""
    B, Np, C = x.shape
    act, mm = x.dtype, p.mm_dtype
    h = _ln(x, p.ln1_w, p.ln1_b, LN_EPS).to(act)
    qkv = (_mmf(h, mm) @ _mmf(p.w_qkv, mm).T + p.b_qkv).to(act)
    return qkv.reshape(B, Np, 3, p.heads, p.hd).permute(2, 0, 3, 1, 4).contiguous()


def _check_mode(mode: str) -> str:
    if mode not in ATTN_MODES:
        raise ValueError(f"attention mode must be one of {ATTN_MODES}, got {mode!r}")
    return mode


def aligned_offsets(C: int, heads: int, hd: int) -> Tuple[int, ...]:
    """aligned_hcat's column offset of head h inside each third of qkv,
    (h 128) mod 2C (K11 `hoff`); ValueError where a head's slice of a third
    (at off 0, C or 2C) runs past 3C, where the TPU body cannot be traced."""
    offs = tuple((h * 128) % (2 * C) for h in range(heads))
    over = [(third, h) for third in range(3) for h, o in enumerate(offs)
            if third * C + o + hd > 3 * C]
    if over:
        third, h = over[0]
        raise ValueError(
            f"aligned_hcat is undefined at C={C}, {heads} heads of {hd}: head {h}'s slice of "
            f"third {third} spans columns {third * C + offs[h]}..{third * C + offs[h] + hd} "
            f"past 3C = {3 * C}")
    return offs


def _attn_core(q, k, v, mm: torch.dtype, n_real: Optional[int], mode: str) -> torch.Tensor:
    """One attention mode on head-major q, k, v (B, heads, Np, hd): the
    per-head output, float32 before its rounding."""
    Np = q.shape[-2]
    s = _mmf(q, mm) @ _mmf(k, mm).transpose(-1, -2)  # (B, heads, Np, Np) f32
    pad = None
    if n_real is not None and n_real < Np:
        pad = torch.arange(Np, device=q.device) >= n_real
    if mode == "no_softmax":
        if pad is not None:
            s = s.masked_fill(pad, 0.0)
        return _mmf(s, mm) @ _mmf(v, mm)
    if pad is not None:
        s = s.masked_fill(pad, MASK)
    if mode == "stable":
        return _mmf(torch.softmax(s, -1), mm) @ _mmf(v, mm)
    if mode == "bf16_exp":
        s = s.to(torch.bfloat16).to(torch.float32)
    e = torch.exp(s)  # no row max: overflows where the TPU bodies overflow
    if mode == "norm_before":
        return _mmf(e / e.sum(-1, keepdim=True), mm) @ _mmf(v, mm)
    # fast, bf16_exp
    return (_mmf(e, mm) @ _mmf(v, mm)) * (1.0 / e.sum(-1, keepdim=True))


def _head_outputs(qkv: torch.Tensor, mm: torch.dtype, n_real: Optional[int], mode: str,
                  act: torch.dtype) -> torch.Tensor:
    """Each head's attention output of the head-major qkv (3, B, heads, Np,
    hd) in `mode` (ATTN_MODES), rounded to `act`, as (B, Np, heads hd) with
    head h in columns h hd .."""
    _, B, heads, Np, hd = qkv.shape
    mode = _check_mode(mode)
    q, k, v = qkv[0], qkv[1], qkv[2]
    if mode == "aligned_hcat":
        C = heads * hd
        offs = aligned_offsets(C, heads, hd)
        flat = qkv.permute(1, 3, 0, 2, 4).reshape(B, Np, 3 * C)
        q, k, v = (torch.stack([flat[..., t * C + o: t * C + o + hd] for o in offs], 1)
                   for t in range(3))
        mode = "norm_before"
    if mode == "q_passthrough":
        o = q.to(act)
    else:
        o = _attn_core(q, k, v, mm, n_real, mode).to(act)
    return o.permute(0, 2, 1, 3).reshape(B, Np, heads * hd)


def vit_attn_out_ref(
    x: torch.Tensor,
    qkv: torch.Tensor,
    p: VitBlockParams,
    n_real: Optional[int] = None,
    mode: str = "stable",
) -> torch.Tensor:
    """Plain version of the vit_attn and vit_proj kernels together:
    attention of the head-major qkv (3, B, heads, Np, hd) over the keys <
    n_real in `mode` (ATTN_MODES), proj, + x -> (B, Np, C) in x's dtype."""
    act, mm = x.dtype, p.mm_dtype
    o = _head_outputs(qkv, mm, n_real, mode, act)
    o = _mmf(o, mm) @ _mmf(p.w_proj, mm).T + p.b_proj
    return (x.to(torch.float32) + o).to(act)


def vit_attn_core_ref(
    qkv: torch.Tensor,
    p: VitBlockParams,
    n_real: Optional[int] = None,
    mode: str = "stable",
) -> torch.Tensor:
    """Plain version of the vit_attn kernel: each head's attention of the
    head-major qkv (3, B, heads, Np, hd) over the keys < n_real in `mode`,
    rounded to qkv's dtype, heads concatenated -> o_pre (B, Np, C)."""
    return _head_outputs(qkv, p.mm_dtype, n_real, mode, qkv.dtype)


def vit_proj_ref(o: torch.Tensor, x: torch.Tensor, p: VitBlockParams) -> torch.Tensor:
    """Plain version of the vit_proj kernel: x + (o_pre W_proj^T + b_proj)
    in float32, rounded once to x's dtype."""
    mm = p.mm_dtype
    o = _mmf(o, mm) @ _mmf(p.w_proj, mm).T + p.b_proj
    return (x.to(torch.float32) + o).to(x.dtype)


def vit_attn_ref(
    x: torch.Tensor,
    p: VitBlockParams,
    n_real: Optional[int] = None,
    mode: str = "stable",
) -> torch.Tensor:
    """Plain version of the attention half (`_attn_half`): x (B, Np, C) ->
    x + proj(attention(LN1(x))), x's dtype."""
    return vit_attn_out_ref(x, vit_qkv_ref(x, p), p, n_real, mode)


def vit_mlp_ref(x: torch.Tensor, p: VitBlockParams) -> torch.Tensor:
    """Plain version of the MLP half (`_mlp_half`), per token of x."""
    act, mm = x.dtype, p.mm_dtype
    m = _ln(x, p.ln2_w, p.ln2_b, LN_EPS).to(act)
    m = _mmf(m, mm) @ _mmf(p.w_fc1, mm).T + p.b_fc1
    m = F.gelu(m, approximate="none").to(act)
    m = _mmf(m, mm) @ _mmf(p.w_fc2, mm).T + p.b_fc2
    return (x.to(torch.float32) + m).to(act)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda_args(x: torch.Tensor, p: VitBlockParams, attn: bool):
    if x.dtype != torch.bfloat16 or p.mm_dtype != torch.bfloat16:
        raise TypeError(
            f"CUDA ViT kernels take bfloat16 activations and weights, got "
            f"{x.dtype} / {p.mm_dtype}"
        )
    if not x.is_contiguous() or x.dim() != 3:
        raise ValueError("x must be a contiguous (B, Np, C) tensor")
    C = x.shape[2]
    if C != p.dim or p.w_qkv.device != x.device:
        raise ValueError("weights and x differ in width or device")
    if attn and (C not in ATTN_WIDTHS or p.hd != HD):
        raise ValueError(f"the attention kernels take C 384 or 768 (ViT-S, ViT-B) or 1024 "
                         f"(ViT-L) with head dim {HD}, got C {C}, head dim {p.hd}")
    if attn and x.shape[1] % 16:
        raise ValueError(f"the attention kernels take tokens padded to a multiple of 16 "
                         f"(pad_tokens), got {x.shape[1]}")
    widths = MLP_WIDTHS + vit_plan.ROWS_WIDTHS
    if not attn and (C not in widths or p.hidden % 128):
        raise ValueError(f"the MLP kernels take C in {widths} and hidden a multiple of 128, "
                         f"got C {C}, hidden {p.hidden}")


def ln1_rows(x: torch.Tensor, p: VitBlockParams) -> torch.Tensor:
    """Plain LN1(x) in x's dtype as (B Np, C) rows: the operand vit_qkv_ref
    multiplies, and vit_qkv's optional second output."""
    return _ln(x, p.ln1_w, p.ln1_b, LN_EPS).to(x.dtype).reshape(-1, x.shape[-1])


def vit_qkv(x: torch.Tensor, p: VitBlockParams, return_ln: bool = False):
    """LN1 and the qkv product, head-major (see vit_qkv_ref). return_ln=True
    also returns LN1(x) as (B Np, C) rows in x's dtype, written by the same
    call: (qkv, ln1)."""
    if x.device.type == "cpu":
        qkv = vit_qkv_ref(x, p)
        return (qkv, ln1_rows(x, p)) if return_ln else qkv
    _check_cuda_args(x, p, attn=True)
    B, Np, C = x.shape
    from . import _build

    lib = _build.load_library()
    qkv = torch.empty((3, B, p.heads, Np, HD), dtype=x.dtype, device=x.device)
    rows = C in vit_plan.ROWS_WIDTHS  # C 1024: the row pass writes LN1(x) in any case
    h = torch.empty((B * Np, C), dtype=x.dtype, device=x.device) if return_ln or rows else None
    if rows:
        _check_aligned(x, p.w_qkv, p.b_qkv, p.ln1_w, p.ln1_b)
        plan = vit_plan.qkv_plan(B * Np, C, sm_count(x.device))
        rc = lib.vit_qkv_rows_launch(
            _ptr(x), _ptr(qkv), _ptr(h), _ptr(p.w_qkv), _ptr(p.b_qkv), _ptr(p.ln1_w),
            _ptr(p.ln1_b), B * Np, Np, C, p.heads, plan.qkv.grid, LN_EPS, _cuda_stream(x),
        )
    else:
        rc = lib.vit_qkv_launch(
            _ptr(x), _ptr(qkv), _ptr(h), _ptr(p.w_qkv), _ptr(p.b_qkv), _ptr(p.ln1_w),
            _ptr(p.ln1_b), B * Np, Np, C, p.heads, LN_EPS, _cuda_stream(x),
        )
    _check_launch("vit_qkv", rc)
    vit_qkv.launches += 1
    return (qkv, h) if return_ln else qkv


def vit_attn(
    qkv: torch.Tensor,
    p: VitBlockParams,
    n_real: Optional[int] = None,
    mode: str = "stable",
) -> torch.Tensor:
    """Attention of the head-major qkv in `mode`, each head rounded into its
    column block of o_pre (B, Np, C) (see vit_attn_core_ref)."""
    if qkv.device.type == "cpu":
        return vit_attn_core_ref(qkv, p, n_real, mode)
    mode = _check_mode(mode)
    if qkv.dtype != torch.bfloat16 or p.mm_dtype != torch.bfloat16:
        raise TypeError(f"CUDA ViT kernels take bfloat16 activations and weights, got "
                        f"{qkv.dtype} / {p.mm_dtype}")
    if qkv.dim() != 5 or not qkv.is_contiguous():
        raise ValueError("qkv must be a contiguous (3, B, heads, Np, hd) tensor")
    _, B, heads, Np, hd = qkv.shape
    C = heads * hd
    if C not in ATTN_WIDTHS or hd != HD or heads != p.heads or p.w_proj.device != qkv.device:
        raise ValueError(f"the attention kernel takes C in {ATTN_WIDTHS} with head dim {HD} and "
                         f"the block's heads on its device, got {heads} heads of {hd}")
    if mode == "aligned_hcat":
        # at every shape the kernel takes (head dim 64, 6, 12 or 16 heads)
        # a slice runs past 3C: this raises before any launch
        aligned_offsets(C, heads, hd)
    n_real = Np if n_real is None else n_real
    if not 0 < n_real <= Np:
        raise ValueError(f"n_real {n_real} outside (0, {Np}]")
    from . import _build

    lib = _build.load_library()
    out = torch.empty((B, Np, C), dtype=qkv.dtype, device=qkv.device)
    rc = lib.vit_attn_launch(
        _ptr(qkv), _ptr(out), B, Np, C, heads, n_real, _MODE_ID[mode], _cuda_stream(qkv),
    )
    _check_launch("vit_attn", rc)
    vit_attn.launches += 1
    vit_attn.mode_launches[mode] += 1
    return out


def vit_proj(o: torch.Tensor, x: torch.Tensor, p: VitBlockParams) -> torch.Tensor:
    """proj of the head outputs o_pre, its bias and the residual x (see
    vit_proj_ref)."""
    if x.device.type == "cpu":
        return vit_proj_ref(o, x, p)
    _check_cuda_args(x, p, attn=True)
    if o.shape != x.shape or o.dtype != x.dtype or o.device != x.device or not o.is_contiguous():
        raise ValueError(f"o_pre must be a contiguous bf16 tensor shaped as x {tuple(x.shape)}")
    B, Np, C = x.shape
    from . import _build

    lib = _build.load_library()
    out = torch.empty_like(x)
    rc = lib.vit_proj_launch(
        _ptr(o), _ptr(x), _ptr(out), _ptr(p.w_proj), _ptr(p.b_proj), B * Np, C,
        _cuda_stream(x),
    )
    _check_launch("vit_proj", rc)
    vit_proj.launches += 1
    return out


def vit_mlp(x: torch.Tensor, p: VitBlockParams) -> torch.Tensor:
    """MLP half of a ViT block on the swin_mlp kernel with LN eps 1e-6, at
    C 1024 on csrc/vit_rows.cu (see vit_mlp_ref)."""
    if x.device.type == "cpu":
        return vit_mlp_ref(x, p)
    _check_cuda_args(x, p, attn=False)
    B, Np, C = x.shape
    w = (p.ln2_w, p.ln2_b, p.w_fc1, p.b_fc1, p.w_fc2, p.b_fc2)
    if C in vit_plan.ROWS_WIDTHS:
        out = _mlp_rows_launch(x, w, B * Np)
    else:
        out = _mlp_launch("vit_mlp", x, w, B * Np, Np, None, LN_EPS)
    vit_mlp.launches += 1
    return out


def _mlp_rows_launch(x: torch.Tensor, w, n_tokens: int) -> torch.Tensor:
    """The MLP half at C 1024 (csrc/vit_rows.cu: the LN2 row pass, fc1 with
    GELU, fc2 with the residual, on ops/vit_plan.py's plan); w as
    _mlp_launch's."""
    from . import _build

    C, hidden = x.shape[-1], w[2].shape[0]
    plan = vit_plan.mlp_plan(n_tokens, C, hidden, sm_count(x.device))
    _check_aligned(x, *w)
    lib = _build.load_library()
    out = torch.empty_like(x)
    h = torch.empty((n_tokens, C), dtype=x.dtype, device=x.device)
    g = torch.empty((n_tokens, hidden), dtype=x.dtype, device=x.device)
    rc = lib.vit_mlp_rows_launch(
        _ptr(x), _ptr(out), _ptr(h), _ptr(g), *(_ptr(t) for t in w), n_tokens, C, hidden,
        plan.fc1.grid, plan.fc2.grid, LN_EPS, _cuda_stream(x),
    )
    _check_launch("vit_mlp", rc)
    return out


vit_qkv.launches = 0
vit_attn.launches = 0
vit_attn.mode_launches = dict.fromkeys(_MODE_ID, 0)  # vit_attn's launches by mode
vit_proj.launches = 0
vit_mlp.launches = 0
COUNTED = [vit_qkv, vit_attn, vit_proj, vit_mlp]


def launch_counts() -> dict:
    """Launches of every counted ViT kernel since the last reset."""
    return {f.__name__: f.launches for f in COUNTED}


def mode_launch_counts() -> dict:
    """vit_attn's launches by attention mode since the last reset."""
    return dict(vit_attn.mode_launches)


def reset_launch_counts() -> None:
    for f in COUNTED:
        f.launches = 0
    vit_attn.mode_launches = dict.fromkeys(_MODE_ID, 0)


# ---------------------------------------------------------------------------
# the three TPU entry points
# ---------------------------------------------------------------------------


def _impl(impl: str):
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    return impl == "plain"


def fused_vit_attn(
    x: torch.Tensor,
    p: VitBlockParams,
    n_real: Optional[int] = None,
    mode: str = "stable",
    impl: str = "kernel",
) -> torch.Tensor:
    """Attention half (LN1, qkv, attention in `mode`, proj, residual) of one
    ViT block on x (B, Np, C); n_real < Np masks the padded key columns."""
    if _impl(impl):
        return vit_attn_ref(x, p, n_real, mode)
    if mode == "aligned_hcat":  # undefined shapes raise before any launch
        aligned_offsets(x.shape[2], p.heads, p.hd)
    return vit_proj(vit_attn(vit_qkv(x, p), p, n_real, mode), x, p)


def fused_vit_mlp(x: torch.Tensor, p: VitBlockParams, impl: str = "kernel") -> torch.Tensor:
    """MLP half (LN2, fc1, GELU, fc2, residual) of one ViT block."""
    return vit_mlp_ref(x, p) if _impl(impl) else vit_mlp(x, p)


def fused_vit_block(
    x: torch.Tensor,
    p: VitBlockParams,
    n_real: Optional[int] = None,
    mode: str = "stable",
    impl: str = "kernel",
) -> torch.Tensor:
    """One eval ViT block on x (B, Np, C), Np a multiple of 16 (pad_tokens):
    the attention half in `mode`, then the MLP half. On a card every block
    is these three launches; the TPU's whole-block / split-pair plan
    (block_plan) is a VMEM budget that has no counterpart here."""
    return fused_vit_mlp(fused_vit_attn(x, p, n_real, mode, impl), p, impl)
