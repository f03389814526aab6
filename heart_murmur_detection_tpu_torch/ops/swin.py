"""Swin blocks for HTS-AT: two hand-written CUDA kernels, their plain torch
versions, and the three eval entry points of
heart_murmur_detection_tpu/ops/pallas_swin.py built from them.

  swin_attn  LN1 -> 8x8 windows -> qkv -> per-head softmax(q k^T/sqrt(hd)
             + rel-pos bias (+ shift mask)) v -> proj -> +x
             (csrc/swin_attn.cu, wgmma and TMA; the TPU body is `_strip_attn`)
  swin_mlp   LN2 -> fc1 -> exact GELU -> fc2 -> +x
             (csrc/swin_mlp.cu, wgmma and TMA; the TPU body is `_strip_mlp`)

Each launch follows a plan computed on the host from the geometry and the
card's SM count (ops/swin_plan.py: token rows or windows a block, and the
cluster that splits the hidden chunks or the heads where the grid is small).

Both take an optional per-sample multiplier kmul (B,) of the branch, the
DropPath keep multipliers of the training forward (ops/swin_train.py);
without it they are the eval halves, bit for bit. block_layout builds the
kernel weight layout with differentiable ops (the training path, inside
autograd every step); prep_block builds it once, detached, for inference.

  fused_swin_block        swin_attn then swin_mlp          (TPU K1, :480)
  fused_swin_pair         block(s=0), then block(s, mask)  (TPU K2, :847)
  fused_swin_block_split  the same two launches at C=768   (TPU K3, :618)

The cyclic shift of a shifted block lives in the addressing on both axes:
token (r, c) of rolled window (i, j) is x[(8i+r+s) mod H, (8j+c+s) mod W],
read and written in place of the roll, so no rolled copy of x is ever made.
The TPU pair kept a whole map in VMEM; a stage-0 map (768 KiB a clip) does
not fit an SM's shared memory, so on Hopper a pair is four launches.

Dispatch: a CPU tensor runs the plain version; a CUDA bfloat16 tensor
launches the kernel; any other CUDA dtype raises. `impl="plain"` asks for
the plain version on any device (the tests and the on-card reference).
The plain versions round to the activation dtype at the same points as the
TPU body and the kernels: qkv, the scaled q, the attention output, h1, the
GELU output and the block output.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

WINDOW = 8
HDP = 32  # head dim padded to the MMA k-depth multiple (HTS-AT's hd is 24)


@dataclasses.dataclass(frozen=True)
class SwinBlockParams:
    """One eval swin block, laid out for the kernels once at weight load
    (the counterpart of pallas_swin._prep_weights). Matmul weights keep the
    torch (out, in) layout in the matmul dtype; the qkv rows are padded per
    head from hd to hdp, the next multiple of HDP, with zeros (the kernels
    take hdp = HDP; exact: padded q/k columns add 0 to the
    logits, padded v columns are dropped before proj). LayerNorm parameters,
    biases and the gathered relative-position bias (heads, N, N) are float32.
    """

    heads: int
    hd: int
    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    w_qkv: torch.Tensor  # (3 * heads * hdp, C)
    b_qkv: torch.Tensor  # (3 * heads * hdp,)
    w_proj: torch.Tensor  # (C, C)
    b_proj: torch.Tensor
    bias: torch.Tensor  # (heads, N, N)
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
    def mm_dtype(self) -> torch.dtype:
        return self.w_qkv.dtype

    @property
    def hdp(self) -> int:
        return self.w_qkv.shape[0] // (3 * self.heads)


def block_layout(
    get,
    heads: int,
    bias: torch.Tensor,
    mm_dtype: torch.dtype,
) -> SwinBlockParams:
    """Lay out one block's weights for the kernels (pallas_swin._prep_weights)
    with differentiable torch ops: `get(name)` returns the float32 tensor of a
    reference key (norm1.weight, attn.qkv.weight, ...). The training path
    builds this inside autograd every step, so the gradients of the padded
    bf16 layout flow back to the float32 parameters; prep_block builds it
    once, detached, for inference."""
    C = get("attn.proj.weight").shape[0]
    hd = C // heads
    if heads * hd != C:
        raise ValueError(f"{heads} heads must divide C = {C}")
    hdp = -(-hd // HDP) * HDP
    w_qkv = get("attn.qkv.weight").reshape(3, heads, hd, C)
    w_qkv = F.pad(w_qkv, (0, 0, 0, hdp - hd)).reshape(3 * heads * hdp, C)
    b_qkv = F.pad(get("attn.qkv.bias").reshape(3, heads, hd), (0, hdp - hd)).reshape(-1)
    mm = lambda t: t.to(mm_dtype).contiguous()
    f32 = lambda t: t.contiguous()
    return SwinBlockParams(
        heads=heads,
        hd=hd,
        ln1_w=f32(get("norm1.weight")),
        ln1_b=f32(get("norm1.bias")),
        w_qkv=mm(w_qkv),
        b_qkv=f32(b_qkv),
        w_proj=mm(get("attn.proj.weight")),
        b_proj=f32(get("attn.proj.bias")),
        bias=bias.to(torch.float32).contiguous(),
        ln2_w=f32(get("norm2.weight")),
        ln2_b=f32(get("norm2.bias")),
        w_fc1=mm(get("mlp.fc1.weight")),
        b_fc1=f32(get("mlp.fc1.bias")),
        w_fc2=mm(get("mlp.fc2.weight")),
        b_fc2=f32(get("mlp.fc2.bias")),
    )


def prep_block(
    sd: Mapping[str, torch.Tensor],
    heads: int,
    bias: torch.Tensor,
    mm_dtype: torch.dtype,
    device=None,
) -> SwinBlockParams:
    """Lay out one block's weights for the kernels, detached, once at weight
    load (pallas_swin._prep_weights).

    sd: the block's state_dict under the reference key names (norm1.*,
    attn.qkv.*, attn.proj.*, norm2.*, mlp.fc1.*, mlp.fc2.*); bias: its
    gathered relative-position bias (heads, N, N)."""
    g = lambda k: sd[k].detach().to(device=device, dtype=torch.float32)
    return block_layout(g, heads, bias.detach().to(device=device), mm_dtype)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5):
    """LayerNorm with float32 statistics (the TPU bodies' `_ln`)."""
    x = x.to(torch.float32)
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _mmf(t: torch.Tensor, mm_dtype: torch.dtype) -> torch.Tensor:
    """Round a matmul operand to the matmul dtype, then compute in float32:
    a float32 product of bf16-valued operands is a bf16 product with f32
    accumulation."""
    return t.to(mm_dtype).to(torch.float32)


def swin_attn_ref(
    x: torch.Tensor,
    p: SwinBlockParams,
    mask: Optional[torch.Tensor] = None,
    shift: int = 0,
    fast_softmax: bool = False,
    window: int = WINDOW,
    kmul: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the swin_attn kernel: x (B, H, W, C) -> h1, same
    dtype. mask (nW, N, N) is indexed in the rolled frame. kmul (B,) float32
    scales the branch per sample (DropPath keep multipliers of the training
    forward): h1 = x + kmul * attn(x)."""
    B, H, W, C = x.shape
    act, mm = x.dtype, p.mm_dtype
    heads, hd = p.heads, p.hd
    nwh, nww = H // window, W // window
    N = window * window
    Bn = B * nwh * nww
    xr = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
    xw = (
        xr.reshape(B, nwh, window, nww, window, C)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(Bn, N, C)
    )
    h = _ln(xw, p.ln1_w, p.ln1_b)
    qkv = (_mmf(h, mm) @ _mmf(p.w_qkv, mm).T + p.b_qkv).to(act)
    qkv = qkv.reshape(Bn, N, 3, heads, p.hdp).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (Bn, heads, N, hdp)
    # hd^-0.5 as a constant of the activation dtype, as the JAX body applies it
    qs = q * torch.tensor(hd**-0.5, dtype=act, device=q.device)
    a = _mmf(qs, mm) @ _mmf(k, mm).transpose(-1, -2) + p.bias
    if mask is not None:
        a = (a.reshape(B, nwh * nww, heads, N, N) + mask[None, :, None]).reshape(
            Bn, heads, N, N
        )
    if fast_softmax:
        e = torch.exp(a)
        recip = 1.0 / e.sum(-1, keepdim=True)
        ost = ((_mmf(e, mm) @ _mmf(v, mm)) * recip).to(act)
    else:
        ost = (_mmf(torch.softmax(a, -1), mm) @ _mmf(v, mm)).to(act)
    o = ost[..., :hd].permute(0, 2, 1, 3).reshape(Bn, N, C)
    o = _mmf(o, mm) @ _mmf(p.w_proj, mm).T + p.b_proj
    if kmul is not None:
        o = kmul.reshape(B, 1, 1).repeat_interleave(nwh * nww, 0) * o
    h1 = (xw.to(torch.float32) + o).to(act)
    h1 = (
        h1.reshape(B, nwh, nww, window, window, C)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(B, H, W, C)
    )
    return torch.roll(h1, (shift, shift), (1, 2)) if shift else h1


def swin_mlp_ref(
    x: torch.Tensor, p: SwinBlockParams, kmul: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain version of the swin_mlp kernel: per token of x (B, H, W, C),
    same dtype as x; kmul (B,) float32 scales the branch per sample."""
    act, mm = x.dtype, p.mm_dtype
    m = _ln(x, p.ln2_w, p.ln2_b)
    m = _mmf(m, mm) @ _mmf(p.w_fc1, mm).T + p.b_fc1
    m = F.gelu(m, approximate="none").to(act)
    m = _mmf(m, mm) @ _mmf(p.w_fc2, mm).T + p.b_fc2
    if kmul is not None:
        m = kmul.reshape(-1, *([1] * (x.dim() - 1))) * m
    return (x.to(torch.float32) + m).to(act)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's address for a c_void_p argument (None: NULL)."""
    return None if t is None else t.data_ptr()


def _check_launch(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _check_cuda_args(x: torch.Tensor, p: SwinBlockParams, window: int):
    if x.dtype != torch.bfloat16 or p.mm_dtype != torch.bfloat16:
        raise TypeError(
            f"CUDA swin kernels take bfloat16 activations and weights, got "
            f"{x.dtype} / {p.mm_dtype}"
        )
    if not x.is_contiguous() or x.dim() != 4:
        raise ValueError("x must be a contiguous (B, H, W, C) tensor")
    if window != WINDOW:
        raise ValueError(f"the kernels take window {WINDOW}, got {window}")
    B, H, W, C = x.shape
    if C not in (96, 192, 384, 768) or H % WINDOW or W % WINDOW or p.hdp != HDP:
        raise ValueError(f"unsupported swin geometry {tuple(x.shape)}, head dim {p.hd}")
    if p.w_qkv.device != x.device:
        raise ValueError("weights and x are on different devices")


def _cuda_stream(x: torch.Tensor) -> int:
    """The raw handle of the current stream on x's card, for a c_void_p
    argument: one call into torch, no Stream object (a launch's host work
    is most of a short kernel's time)."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


_SMS = {}


def sm_count(device: torch.device) -> int:
    """The SM count of a card, read once (the launch plans' input)."""
    i = device.index if device.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def _check_aligned(*ts: Optional[torch.Tensor]):
    """The kernels read tensors by TMA boxes and 8- or 16-byte vectors."""
    if any(t is not None and t.data_ptr() % 16 for t in ts):
        raise ValueError("the swin / ViT MLP and attention kernels take 16-byte aligned tensors")


def _mlp_launch(name: str, x: torch.Tensor, w, n_tokens: int, hw: int, kmul, eps: float):
    """One launch of csrc/swin_mlp.cu on its plan (ops/swin_plan.py); w:
    (ln2_w, ln2_b, w_fc1, b_fc1, w_fc2, b_fc2). Returns the output."""
    from . import _build
    from .swin_plan import mlp_plan

    C = x.shape[-1]
    hidden = w[2].shape[0]
    plan = mlp_plan(n_tokens, C, hidden, sm_count(x.device))
    _check_aligned(x, *w)
    lib = _build.load_library()
    out = torch.empty_like(x)
    rc = lib.swin_mlp_launch(
        _ptr(x), _ptr(out), *(_ptr(t) for t in w), _ptr(kmul), n_tokens, C, hidden, hw,
        plan.panel_rows, plan.ks, plan.stages, eps, _cuda_stream(x),
    )
    _check_launch(name, rc)
    return out


def _check_kmul(kmul: Optional[torch.Tensor], x: torch.Tensor) -> Optional[torch.Tensor]:
    """A per-sample branch multiplier for a kernel: float32 (B,) on x's card."""
    if kmul is None:
        return None
    if kmul.dtype != torch.float32 or kmul.numel() != x.shape[0] or kmul.device != x.device:
        raise ValueError(f"kmul must be float32 with one value per sample on {x.device}")
    return kmul.reshape(-1).contiguous()


def swin_attn(
    x: torch.Tensor,
    p: SwinBlockParams,
    mask: Optional[torch.Tensor] = None,
    shift: int = 0,
    fast_softmax: bool = False,
    window: int = WINDOW,
    kmul: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention half of a swin block (see swin_attn_ref for the math)."""
    if x.device.type == "cpu":
        return swin_attn_ref(x, p, mask, shift, fast_softmax, window, kmul)
    _check_cuda_args(x, p, window)
    kmul = _check_kmul(kmul, x)
    B, H, W, C = x.shape
    if mask is not None:
        nw = (H // WINDOW) * (W // WINDOW)
        if mask.dtype != torch.float32 or tuple(mask.shape) != (nw, 64, 64):
            raise ValueError("mask must be float32 (nW, 64, 64)")
        if mask.device != x.device:
            raise ValueError("mask and x are on different devices")
        mask = mask.contiguous()
    from . import _build
    from .swin_plan import attn_plan

    plan = attn_plan(B, H, W, C, p.heads, sm_count(x.device))
    _check_aligned(x, p.w_qkv, p.b_qkv, p.w_proj, p.b_proj, p.bias, mask)
    lib = _build.load_library()
    out = torch.empty_like(x)
    rc = lib.swin_attn_launch(
        _ptr(x), _ptr(out), _ptr(p.w_qkv), _ptr(p.b_qkv), _ptr(p.w_proj),
        _ptr(p.b_proj), _ptr(p.ln1_w), _ptr(p.ln1_b), _ptr(p.bias), _ptr(mask),
        _ptr(kmul), B, H, W, C, p.heads, shift, int(fast_softmax), plan.windows_per_block,
        plan.cs, plan.proj_width, plan.stages, _cuda_stream(x),
    )
    _check_launch("swin_attn", rc)
    swin_attn.launches += 1
    return out


def swin_mlp(
    x: torch.Tensor, p: SwinBlockParams, kmul: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """MLP half of a swin block (see swin_mlp_ref for the math)."""
    if x.device.type == "cpu":
        return swin_mlp_ref(x, p, kmul)
    _check_cuda_args(x, p, WINDOW)
    kmul = _check_kmul(kmul, x)
    B, H, W, C = x.shape
    out = _mlp_launch("swin_mlp", x, (p.ln2_w, p.ln2_b, p.w_fc1, p.b_fc1, p.w_fc2, p.b_fc2),
                      B * H * W, H * W, kmul, 1e-5)
    swin_mlp.launches += 1
    return out


swin_attn.launches = 0
swin_mlp.launches = 0
# every counted kernel wrapper; ops/swin_train.py adds its own on import
COUNTED = [swin_attn, swin_mlp]


def launch_counts() -> dict:
    """Launches of every counted swin kernel since the last reset."""
    return {f.__name__: f.launches for f in COUNTED}


def reset_launch_counts() -> None:
    for f in COUNTED:
        f.launches = 0


# ---------------------------------------------------------------------------
# the three TPU entry points
# ---------------------------------------------------------------------------


def fused_swin_block(
    x: torch.Tensor,
    p: SwinBlockParams,
    mask: Optional[torch.Tensor] = None,
    shift: int = 0,
    fast_softmax: bool = False,
    impl: str = "kernel",
    window: int = WINDOW,
) -> torch.Tensor:
    """One eval swin block on spatial x (B, H, W, C): attention half, then
    MLP half. shift > 0 is a shifted block (both cyclic rolls in the
    addressing); mask is its (nW, N, N) additive mask."""
    if impl == "plain":
        return swin_mlp_ref(swin_attn_ref(x, p, mask, shift, fast_softmax, window), p)
    if impl != "kernel":
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    return swin_mlp(swin_attn(x, p, mask, shift, fast_softmax, window), p)


def fused_swin_pair(
    x: torch.Tensor,
    pa: SwinBlockParams,
    pb: SwinBlockParams,
    mask: torch.Tensor,
    shift: int,
    fast_softmax: bool = False,
    impl: str = "kernel",
    window: int = WINDOW,
) -> torch.Tensor:
    """(regular block a, shifted block b): block(x) -> roll(-s) ->
    block(., mask) -> roll(+s), as four launches with no roll between them."""
    if shift <= 0 or mask is None:
        raise ValueError("fused_swin_pair needs shift > 0 and its mask")
    y = fused_swin_block(x, pa, None, 0, fast_softmax, impl, window)
    return fused_swin_block(y, pb, mask, shift, fast_softmax, impl, window)


# The TPU split block (an attention-half launch plus an MLP-half launch, for
# the C=768 stage whose weights overflow VMEM). On Hopper every block is
# already those two launches.
fused_swin_block_split = fused_swin_block
