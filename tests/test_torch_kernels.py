"""The CUDA kernels of heart_murmur_detection_tpu_torch: the build and its
ctypes binding (CPU), and, on a card only, each kernel against its plain
torch version: the swin eval kernels at the four HTS-AT stage geometries,
the swin training kernels (forward with DropPath multipliers, both backward
halves, the weight-gradient products and the ordered reduction) at stages
0-2 (the reduction also at the ViT backward wrappers' shapes), the ViT kernels (vit_qkv, vit_attn and vit_proj, vit_mlp) at the
operaGT and Audio-MAE shapes, vit_attn's K10 / K11 attention modes, and the
fused log-mel kernel (with its float64 precision check) and the polyphase
resampler at the extraction path's shapes.

Imports no JAX, so it also runs where JAX is absent; on a card:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m gpu
"""

import ctypes

import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu_torch.models.htsat import (
    _relative_position_index,
    _shift_attn_mask,
)
from heart_murmur_detection_tpu_torch.ops import _build, swin, swin_train, vit

COS_BAR = 0.99999  # one kernel vs its plain version, on the branch out - x


def _params(C, heads, seed, device, dtype=torch.bfloat16):
    r = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy((r.standard_normal(s) * 0.05).astype(np.float32))
    sd = {
        "norm1.weight": 1 + f(C), "norm1.bias": f(C),
        "attn.qkv.weight": f(3 * C, C), "attn.qkv.bias": f(3 * C),
        "attn.proj.weight": f(C, C), "attn.proj.bias": f(C),
        "norm2.weight": 1 + f(C), "norm2.bias": f(C),
        "mlp.fc1.weight": f(4 * C, C), "mlp.fc1.bias": f(4 * C),
        "mlp.fc2.weight": f(C, 4 * C), "mlp.fc2.bias": f(C),
    }
    table = f(15 * 15, heads) * 10
    idx = torch.as_tensor(_relative_position_index(8, 8).reshape(-1))
    bias = table[idx].reshape(64, 64, heads).permute(2, 0, 1)
    return swin.prep_block(sd, heads, bias, dtype, device)


def _branch_cos(got, want, x):
    """Cosine of the branches each output adds to x: the residual sum would
    hide a fault of the branch under x."""
    a = (got.double() - x.double()).flatten().cpu()
    b = (want.double() - x.double()).flatten().cpu()
    return float(a @ b / (a.norm() * b.norm()))


def test_signatures_pass_pointers_as_void_p():
    """Every pointer and the stream go through ctypes as c_void_p (a c_int
    would cut a 64-bit pointer); the ints follow, then a LayerNorm eps as a
    c_float where the kernel takes one."""
    n_ptrs = {"swin_attn_launch": 11, "swin_mlp_launch": 9, "swin_attn_bwd_launch": 18,
              "swin_mlp_bwd_launch": 15, "swin_wgrad_launch": 5, "swin_reduce_launch": 2,
              "vit_qkv_launch": 7, "vit_attn_launch": 2, "vit_proj_launch": 5,
              "vit_attn_bwd_launch": 16, "vit_mm_launch": 3,
              "logmel_launch": 5, "vit_qkv_rows_launch": 7, "vit_mlp_rows_launch": 10}
    with_eps = {"swin_mlp_launch", "vit_qkv_launch", "swin_mlp_bwd_launch",
                "vit_attn_bwd_launch", "vit_qkv_rows_launch", "vit_mlp_rows_launch"}
    assert set(_build._SIGNATURES) == set(n_ptrs)
    for name, argtypes in _build._SIGNATURES.items():
        assert argtypes[-1] is ctypes.c_void_p, name  # the stream
        n_ptr = n_ptrs[name]
        n_int = len(argtypes) - n_ptr - 1 - (name in with_eps)
        assert all(a is ctypes.c_void_p for a in argtypes[:n_ptr]), name
        assert all(a is ctypes.c_int for a in argtypes[n_ptr:n_ptr + n_int]), name
        assert (argtypes[-2] is ctypes.c_float) == (name in with_eps), name


def test_build_targets_sm90a_and_hashes_sources():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    srcs = {p.rsplit("/", 1)[-1] for p in _build._sources()}
    assert {"swin_attn.cu", "swin_mlp.cu", "swin_common.cuh", "swin_attn_bwd.cu",
            "swin_mlp_bwd.cu", "swin_bwd_common.cuh", "swin_wgrad.cu", "vit_qkv.cu", "vit_attn.cu",
            "vit_attn_common.cuh", "vit_attn_bwd.cu", "logmel.cu", "wgmma_gemm.cuh",
            "vit_proj.cu", "vit_rows.cu"} <= srcs
    # the log-mel kernel is float32-exact: log10f and the FFMAs stay accurate
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    h = _build.source_hash()
    assert h == _build.source_hash() and len(h) == 16


def test_cpu_tensors_never_reach_the_library():
    """A CPU tensor runs the plain version: no build, no launch."""
    p = _params(96, 4, 0, "cpu")
    x = torch.randn(1, 8, 8, 96, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    before = swin.launch_counts()
    assert torch.equal(swin.swin_attn(x, p), swin.swin_attn_ref(x, p))
    assert torch.equal(swin.swin_mlp(x, p), swin.swin_mlp_ref(x, p))
    assert swin.launch_counts() == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    # the plain versions are float32 references: no TF32 in their products
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.gpu
@pytest.mark.parametrize("C,heads,H,shift", [(96, 4, 64, 4), (192, 8, 32, 4), (384, 16, 16, 4), (768, 32, 8, 0)])
@pytest.mark.parametrize("fast_softmax", [False, True])
# B = 1, 16, 64 at every stage (clusters over the heads or the hidden chunks
# where the windows or panels are few, single blocks where they are many),
# and 4 and 72, a block short of whole waves
@pytest.mark.parametrize("B", [1, 4, 16, 64, 72])
def test_kernels_match_plain_on_card(cuda, C, heads, H, shift, fast_softmax, B):
    """Both forward kernels against their plain versions on the branch,
    without and with a per-sample multiplier, and a second launch bitwise
    equal to the first."""
    p = _params(C, heads, C, cuda)
    mask = torch.from_numpy(_shift_attn_mask(H, H, 8, shift)).to(cuda) if shift else None
    g = torch.Generator().manual_seed(C)
    x = (torch.randn(B, H, H, C, generator=g) * 0.5).to(cuda, torch.bfloat16)
    # DropPath keep multipliers, a dropped sample (0) among them where B > 1
    k = torch.tensor([1 / 0.9, 0.0, 1.0, 1 / 0.9] * (B // 4 + 1), device=cuda)[:B]
    n0 = swin.launch_counts()
    for s, m in ((0, None), (shift, mask)):
        for kmul in (None, k):
            got = swin.swin_attn(x, p, m, s, fast_softmax, kmul=kmul)
            want = swin.swin_attn_ref(x, p, m, s, fast_softmax, kmul=kmul)
            again = swin.swin_attn(x, p, m, s, fast_softmax, kmul=kmul)
            torch.cuda.synchronize()
            assert _branch_cos(got, want, x) >= COS_BAR
            assert torch.equal(got, again)
    for kmul in (None, k):
        got, want = swin.swin_mlp(x, p, kmul), swin.swin_mlp_ref(x, p, kmul)
        again = swin.swin_mlp(x, p, kmul)
        torch.cuda.synchronize()
        assert _branch_cos(got, want, x) >= COS_BAR
        assert torch.equal(got, again)
    n1 = swin.launch_counts()
    assert n1["swin_attn"] - n0["swin_attn"] == 8 and n1["swin_mlp"] - n0["swin_mlp"] == 4


@pytest.mark.gpu
def test_non_bf16_on_card_raises(cuda):
    p = _params(96, 4, 1, cuda, torch.float32)
    with pytest.raises(TypeError):
        swin.swin_attn(torch.zeros(1, 8, 8, 96, device=cuda), p)
    with pytest.raises(TypeError):
        swin.swin_mlp(torch.zeros(1, 8, 8, 96, device=cuda), p)


def _cos(a, b):
    a, b = a.double().flatten().cpu(), b.double().flatten().cpu()
    return float(a @ b / (a.norm() * b.norm()))


TRAIN_GEOMETRIES = [(96, 4, 64, 4), (192, 8, 32, 4), (384, 16, 16, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("C,heads,H,shift", TRAIN_GEOMETRIES)
@pytest.mark.parametrize("s", [0, 1])
# B = 1 (the backward kernels' grids below the SM count, a panel or window
# run of one unit a block), 4, and 72 (every block several units, runs that
# start inside a panel)
@pytest.mark.parametrize("B", [1, 4, 72])
def test_train_kernels_match_plain_on_card(cuda, C, heads, H, shift, s, B):
    """Forward halves with DropPath multipliers (a 0 and a 1/0.9 among them,
    from B = 4) and both backward halves against their plain versions: the
    branch of each forward output, dx's branch (dx - dh1) and every gradient
    leaf at a cosine of 0.99999; two launches give bitwise-equal results."""
    shift = shift * s
    p = _params(C, heads, C + 1, cuda)
    mask = torch.from_numpy(_shift_attn_mask(H, H, 8, shift)).to(cuda) if shift else None
    g = torch.Generator().manual_seed(C + 2)
    x = (torch.randn(B, H, H, C, generator=g) * 0.5).to(cuda, torch.bfloat16)
    dy = (torch.randn(B, H, H, C, generator=g) * 0.1).to(cuda, torch.bfloat16)
    k = torch.tensor([0.0, 1 / 0.9, 1.0, 1 / 0.9] * (B // 4) if B >= 4 else [1 / 0.9] * B, device=cuda)
    h1 = swin.swin_attn(x, p, mask, shift, kmul=k)
    h1_ref = swin.swin_attn_ref(x, p, mask, shift, kmul=k)
    y = swin.swin_mlp(h1_ref, p, k)
    y_ref = swin.swin_mlp_ref(h1_ref, p, k)
    torch.cuda.synchronize()
    assert _branch_cos(h1, h1_ref, x) >= COS_BAR
    assert _branch_cos(y, y_ref, h1_ref) >= COS_BAR
    runs = [swin_train.swin_mlp_bwd(h1_ref, dy, k, p) for _ in range(2)]
    dh1_ref, gm_ref = swin_train.swin_mlp_bwd_ref(h1_ref, dy, k, p)
    runs_a = [swin_train.swin_attn_bwd(x, dh1_ref, k, p, mask, shift) for _ in range(2)]
    dx_ref, ga_ref = swin_train.swin_attn_bwd_ref(x, dh1_ref, k, p, mask, shift)
    torch.cuda.synchronize()
    for (d1, g1), (d2, g2) in (runs, runs_a):
        assert torch.equal(d1, d2)
        assert all(torch.equal(g1[n], g2[n]) for n in g1)
    (dh1, gm), (dx, ga) = runs[0], runs_a[0]
    assert _branch_cos(dh1, dh1_ref, dy) >= COS_BAR
    assert _branch_cos(dx, dx_ref, dh1_ref) >= COS_BAR
    for got, want in ((gm, gm_ref), (ga, ga_ref)):
        for n in want:
            assert _cos(got[n], want[n]) >= COS_BAR, n


@pytest.mark.gpu
@pytest.mark.parametrize("C,heads,H,shift", [(96, 4, 64, 4), (768, 32, 8, 0)])
def test_unit_multiplier_keeps_eval_bitwise(cuda, C, heads, H, shift):
    """The forward kernels with kmul = 1 give the eval kernels' output bit
    for bit (k * branch with k = 1 is exact)."""
    p = _params(C, heads, 5, cuda)
    mask = torch.from_numpy(_shift_attn_mask(H, H, 8, shift)).to(cuda) if shift else None
    x = (torch.randn(16, H, H, C, generator=torch.Generator().manual_seed(6)) * 0.5).to(
        cuda, torch.bfloat16)
    one = torch.ones(16, device=cuda)
    assert torch.equal(swin.swin_attn(x, p, mask, shift), swin.swin_attn(x, p, mask, shift, kmul=one))
    assert torch.equal(swin.swin_mlp(x, p), swin.swin_mlp(x, p, one))


def _poison_free_memory(fill: str = "nan"):
    """Fill the memory the caching allocator hands out next with NaN (or a
    normal draw), so a kernel that reads memory it never wrote reads other
    values than in the launch before."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    blocks = [torch.empty(int(free * 0.5) // 4, device="cuda")]
    blocks += [torch.empty(1 << 17, device="cuda") for _ in range(64)]
    for b in blocks:
        b.fill_(float("nan")) if fill == "nan" else b.normal_()
    torch.cuda.synchronize()
    del blocks


# (n, M, N): one chunk; widths of 96 (a 128-wide tile read past the edge);
# the tall-skinny COLA stage-0 products (n = 262144 splits into chunks of
# 6016 tokens, the last one short: a chunk count that does not divide n);
# a stage-1 width; 256-row tiles (M >= 512) at the COLA stage-2 and
# Audio-MAE widths, with two levels of the ordered sum
WGRAD_CASES = [(64, 32, 32), (1024, 96, 1536), (4096 * 4, 384, 96), (65536, 384, 96),
               (262144, 96, 384), (262144, 96, 128), (65536, 192, 256), (16384, 1536, 384),
               (10240, 3072, 768), (10240, 768, 768)]
RAGGED = (262144, 96, 384)


@pytest.mark.gpu
@pytest.mark.parametrize("n,M,N", WGRAD_CASES)
def test_wgrad_and_reduce_match_plain_on_card(cuda, n, M, N):
    """swin_wgrad against the float32 product, one launch a product, and
    bitwise equal again after the allocator's free memory is filled with
    NaN (the workspace and counters it allocates then hold NaN first)."""
    g = torch.Generator().manual_seed(n + M)
    a = torch.randn(n, M, generator=g).to(cuda, torch.bfloat16)
    b = torch.randn(n, N, generator=g).to(cuda, torch.bfloat16)
    S, chunk = swin_train.wgrad_split(n, M, N)
    if (n, M, N) == RAGGED:
        assert S > 1 and n % chunk  # the last chunk is short
    swin.reset_launch_counts()
    got = swin_train.swin_wgrad(a, b)
    want = swin_train.wgrad_ref(a, b)
    torch.cuda.synchronize()
    assert swin.launch_counts()["swin_wgrad"] == 1
    assert got.shape == (M, N) and got.dtype == torch.float32
    assert _cos(got, want) >= COS_BAR
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    assert torch.equal(got, swin_train.swin_wgrad(a, b))
    _poison_free_memory()
    assert torch.equal(got, swin_train.swin_wgrad(a, b))
    parts = torch.randn(7, 1000, generator=g).to(cuda)
    assert torch.equal(swin_train.swin_reduce(parts), swin_train.reduce_ref(parts))


def _vit_reduce_shapes(sms):
    """(S, L) of vit_mlp_bwd's and vit_attn_bwd's partial rows at the ViT-S
    (OPERA-GT CP B=64 x 320 and x 80, fine-tuning B=4 x 1040) and ViT-B
    (Audio-MAE CP B=64 x 160) shapes, S as the wrappers size them."""
    from heart_murmur_detection_tpu_torch.ops.swin_plan import mlp_bwd_plan

    out = []
    for C, n in ((384, 64 * 320), (384, 64 * 80), (384, 4 * 1040), (768, 64 * 160)):
        out.append((mlp_bwd_plan(n, C, 4 * C, sms, kmul=False).part_rows, 7 * C))
        out.append((swin_train._blocks_for(n // swin_train.TOKEN_TILE)[1], 6 * C))
    return out


@pytest.mark.gpu
def test_reduce_is_the_in_order_sum_on_card(cuda):
    """swin_reduce bitwise equal to reduce_ref at every (S, L) of the COLA
    stage 0-2 and the ViT backward wrappers, at widths that are not a
    multiple of 4 and on partials that are not 16-byte aligned (its 4-byte
    copies), one launch a call."""
    from heart_murmur_detection_tpu_torch.bench.wgrad_time import reduce_shapes
    from heart_murmur_detection_tpu_torch.ops.swin_plan import attn_bwd_plan

    sms = swin.sm_count(cuda)
    cola, mae = reduce_shapes(sms)
    shapes = [(S, L) for S, L, _ in cola + mae] + _vit_reduce_shapes(sms)
    a0, a2 = attn_bwd_plan(64, 64, 64, 96, 4, sms), attn_bwd_plan(64, 16, 16, 384, 16, sms)
    assert (a0.part_rows, 17056) in shapes and (a2.part_rows, 68224) in shapes
    assert (160, 4608) in shapes
    g = torch.Generator().manual_seed(5)
    for S, L in shapes + [(7, 1000), (7, 1001), (1, 3), (3000, 5), (513, 1057)]:
        parts = torch.randn(S, L, generator=g).to(cuda)
        swin.reset_launch_counts()
        got = swin_train.swin_reduce(parts)
        assert swin.launch_counts()["swin_reduce"] == 1
        assert torch.equal(got, swin_train.reduce_ref(parts)), (S, L)
    flat = torch.randn(64 * 672 + 1, generator=g).to(cuda)
    parts = flat[1:].view(64, 672)  # 4 bytes past a 16-byte boundary
    assert parts.is_contiguous() and parts.data_ptr() % 16
    assert torch.equal(swin_train.swin_reduce(parts), swin_train.reduce_ref(parts))


@pytest.mark.gpu
@pytest.mark.parametrize("C,heads,H,shift", [(96, 4, 64, 4), (384, 16, 16, 0)])
def test_train_block_function_on_card(cuda, C, heads, H, shift):
    """fused_swin_block_train on CUDA: the kernel path's gradients reach the
    float32 parameters through the padded bf16 layout (built inside
    autograd) as the plain path's do, leaf by leaf at 0.99999."""
    r = np.random.default_rng(C)
    f = lambda *s: torch.tensor((r.standard_normal(s) * 0.05).astype(np.float32), device=cuda)
    sd = {"norm1.weight": 1 + f(C), "norm1.bias": f(C), "attn.qkv.weight": f(3 * C, C),
          "attn.qkv.bias": f(3 * C), "attn.proj.weight": f(C, C), "attn.proj.bias": f(C),
          "norm2.weight": 1 + f(C), "norm2.bias": f(C), "mlp.fc1.weight": f(4 * C, C),
          "mlp.fc1.bias": f(4 * C), "mlp.fc2.weight": f(C, 4 * C), "mlp.fc2.bias": f(C)}
    bias = (f(heads, 64, 64) * 10)
    mask = torch.from_numpy(_shift_attn_mask(H, H, 8, shift)).to(cuda) if shift else None
    x = (f(4, H, H, C) * 10).to(torch.bfloat16)
    k = torch.tensor([0.0, 1 / 0.9, 1.0, 1 / 0.9], device=cuda)
    w_out = f(4, H, H, C)
    grads = {}
    for impl in ("kernel", "plain"):
        leaves = {n: v.clone().requires_grad_() for n, v in sd.items()}
        b = bias.clone().requires_grad_()
        xi = x.clone().requires_grad_()
        p = swin.block_layout(lambda n: leaves[n], heads, b, torch.bfloat16)
        y = swin_train.fused_swin_block_train(xi, p, mask, shift, k, k, impl)
        g = torch.autograd.grad((y.float() * w_out).sum(), [xi, b, *leaves.values()])
        grads[impl] = dict(zip(["x", "bias", *leaves], g))
    torch.cuda.synchronize()
    for n, want in grads["plain"].items():
        got = grads["kernel"][n]
        assert got.dtype == want.dtype and got.shape == want.shape, n
        assert _cos(got, want) >= COS_BAR, n


# ---------------------------------------------------------------------------
# the ViT kernels (MAE encoders)
# ---------------------------------------------------------------------------


def _vit_params(C, heads, seed, device, dtype=torch.bfloat16):
    r = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy((r.standard_normal(s) * 0.05).astype(np.float32))
    sd = {
        "norm1.weight": 1 + f(C), "norm1.bias": f(C),
        "attn.qkv.weight": f(3 * C, C) * 2, "attn.qkv.bias": f(3 * C),
        "attn.proj.weight": f(C, C), "attn.proj.bias": f(C),
        "norm2.weight": 1 + f(C), "norm2.bias": f(C),
        "mlp.fc1.weight": f(4 * C, C), "mlp.fc1.bias": f(4 * C),
        "mlp.fc2.weight": f(C, 4 * C), "mlp.fc2.bias": f(C),
    }
    return vit.prep_vit_block(sd, heads, dtype, device)


# (C, heads, Np, n_real): operaGT ViT-S and Audio-MAE ViT-B
VIT_SHAPES = [(384, 6, 1040, 1025), (768, 12, 528, 513)]


@pytest.mark.gpu
@pytest.mark.parametrize("C,heads,Np,n_real", VIT_SHAPES)
@pytest.mark.parametrize("fast_softmax", [False, True])
def test_vit_kernels_match_plain_on_card(cuda, C, heads, Np, n_real, fast_softmax):
    p = _vit_params(C, heads, C, cuda)
    g = torch.Generator().manual_seed(C + 1)
    x = (torch.randn(3, Np, C, generator=g) * 0.5).to(cuda, torch.bfloat16)
    n0 = vit.launch_counts()
    qkv = vit.vit_qkv(x, p)
    qkv_ref = vit.vit_qkv_ref(x, p)
    mode = "fast" if fast_softmax else "stable"
    o = vit.vit_attn(qkv_ref, p, n_real, mode)
    h1 = vit.vit_proj(o, x, p)
    h1_ref = vit.vit_attn_out_ref(x, qkv_ref, p, n_real, mode)
    y, y_ref = vit.vit_mlp(h1_ref, p), vit.vit_mlp_ref(h1_ref, p)
    torch.cuda.synchronize()
    assert qkv.shape == qkv_ref.shape == (3, 3, heads, Np, 64)
    assert _cos(qkv, qkv_ref) >= COS_BAR
    assert _cos(o, vit.vit_attn_core_ref(qkv_ref, p, n_real, mode)) >= COS_BAR
    assert _branch_cos(h1, h1_ref, x) >= COS_BAR
    assert _branch_cos(y, y_ref, h1_ref) >= COS_BAR
    # bitwise repeatable
    assert torch.equal(vit.vit_attn(qkv_ref, p, n_real, mode), o)
    assert torch.equal(vit.vit_mlp(h1_ref, p), y)
    n1 = vit.launch_counts()
    assert {k: n1[k] - n0[k] for k in n1} == {"vit_qkv": 1, "vit_attn": 2, "vit_proj": 1,
                                              "vit_mlp": 2}


# (C, B, tokens a clip): vit_mlp at token counts its panels (128 rows at
# C <= 192, 64 above) do not divide: the towers' padded sequences at B = 1,
# 16 and 64, the MAE CP visible-token counts, and rows that are no multiple
# of 16 at all; at C 1024 (HeAR, csrc/vit_rows.cu: 128-row tiles) HeAR's
# batches and a ragged count
VIT_MLP_ROWS = [(384, 1, 1040), (384, 16, 1040), (384, 64, 1040), (768, 1, 528), (768, 16, 528),
                (768, 64, 160), (384, 64, 320), (384, 64, 80), (384, 3, 77), (768, 5, 33),
                (96, 7, 50), (192, 3, 130), (1024, 1, 112), (1024, 16, 112), (1024, 64, 112),
                (1024, 3, 77)]


@pytest.mark.gpu
@pytest.mark.parametrize("C,B,Np", VIT_MLP_ROWS)
def test_vit_mlp_ragged_tokens_on_card(cuda, C, B, Np):
    heads = max(1, C // 64)
    p = _vit_params(C, heads, C + Np, cuda)
    g = torch.Generator().manual_seed(Np)
    x = (torch.randn(B, Np, C, generator=g) * 0.5).to(cuda, torch.bfloat16)
    y, y_ref = vit.vit_mlp(x, p), vit.vit_mlp_ref(x, p)
    again = vit.vit_mlp(x, p)
    torch.cuda.synchronize()
    assert _branch_cos(y, y_ref, x) >= COS_BAR
    assert torch.equal(y, again)


# the attention modes of the TPU attention-half kernels K10 / K11 (ops/vit.py
# ATTN_MODES); no_softmax's P v reaches magnitudes far past a softmax row's,
# so it, like every mode, is compared by cosine
ABLATE_MODES = ["norm_before", "fast", "bf16_exp", "no_softmax", "q_passthrough"]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["stable"] + ABLATE_MODES)
@pytest.mark.parametrize("C,heads,Np,n_real", [(384, 6, 1040, 1040), (384, 6, 1040, 1025),
                                               (768, 12, 528, 513)])
def test_vit_attn_modes_match_plain_on_card(cuda, mode, C, heads, Np, n_real):
    """Each attention mode (the served one and K10 / K11's) at the operaGT
    and Audio-MAE shapes on the attention-half weights of
    bench/attn_ablate.py (q unscaled): o_pre against the plain core, the
    core then vit_proj against the plain attention half, the real rows
    unchanged when the padded keys and values change (n_real < Np), two
    launches bitwise equal, also after the allocator's free memory is filled
    with NaN, and one count of each kernel a launch."""
    from heart_murmur_detection_tpu_torch.bench import attn_ablate

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, Np, C)).astype(np.float32))
    x = x.to(cuda, torch.bfloat16)
    p = attn_ablate.half_params(attn_ablate.draw_weights(rng, C), heads, cuda)
    qkv = vit.vit_qkv(x, p)
    vit.reset_launch_counts()
    o = vit.vit_attn(qkv, p, n_real, mode=mode)
    got = vit.vit_proj(o, x, p)
    want = vit.vit_attn_out_ref(x, qkv, p, n_real, mode=mode)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _cos(o, vit.vit_attn_core_ref(qkv, p, n_real, mode=mode)) >= COS_BAR
    assert _branch_cos(got, want, x) >= COS_BAR
    assert vit.mode_launch_counts()[mode] == 1
    assert vit.launch_counts()["vit_attn"] == vit.launch_counts()["vit_proj"] == 1
    if n_real < Np:  # padded keys and values must not leak into real rows
        other = qkv.clone()
        other[1:, :, :, n_real:] = 3.0
        assert torch.equal(vit.vit_attn(other, p, n_real, mode=mode)[:, :n_real], o[:, :n_real])
    assert torch.equal(vit.vit_attn(qkv, p, n_real, mode=mode), o)
    _poison_free_memory()
    assert torch.equal(vit.vit_attn(qkv, p, n_real, mode=mode), o)
    assert torch.equal(vit.vit_proj(o, x, p), got)


@pytest.mark.gpu
@pytest.mark.parametrize("C,heads,Np,B", [(384, 6, 1040, 16), (768, 12, 528, 16),
                                          (768, 12, 160, 64), (384, 6, 48, 2)])
def test_vit_proj_matches_plain_on_card(cuda, C, heads, Np, B):
    """vit_proj (o_pre W_proj^T + b_proj + x, one rounding) against
    vit_proj_ref at the towers' serving, CP and a small shape, bitwise
    repeatable, also after the allocator's free memory is filled with NaN."""
    p = _vit_params(C, heads, C + Np, cuda)
    g = torch.Generator().manual_seed(Np)
    x = (torch.randn(B, Np, C, generator=g) * 0.5).to(cuda, torch.bfloat16)
    o = (torch.randn(B, Np, C, generator=g) * 0.5).to(cuda, torch.bfloat16)
    got, want = vit.vit_proj(o, x, p), vit.vit_proj_ref(o, x, p)
    torch.cuda.synchronize()
    assert _branch_cos(got, want, x) >= COS_BAR
    assert torch.equal(vit.vit_proj(o, x, p), got)
    _poison_free_memory()
    assert torch.equal(vit.vit_proj(o, x, p), got)


# (M, K, N) of the token-row product A (M, K) B (K, N), A K-major and B
# MN-major on the GEMM core: edge tiles in M, N and K (one K step of 8), the
# do and dh products of the Audio-MAE CP step and of operaGT fine-tuning
ROWS_MM_CASES = [(100, 72, 200), (130, 8, 8), (257, 1160, 392), (10240, 768, 768),
                 (10240, 2304, 768), (4160, 1152, 384)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", ROWS_MM_CASES)
def test_rows_mm_matches_torch_on_card(cuda, M, K, N):
    """The GEMM core with mixed majors (vit_attn_bwd's do and dh products,
    through the test-only rows_mm) against the float32 product, bitwise
    repeatable."""
    from heart_murmur_detection_tpu_torch.ops import vit_train

    g = torch.Generator().manual_seed(M + K + N)
    a = torch.randn(M, K, generator=g).to(cuda, torch.bfloat16)
    b = torch.randn(K, N, generator=g).to(cuda, torch.bfloat16)
    got, want = vit_train.rows_mm(a, b), torch.mm(a.float(), b.float())
    torch.cuda.synchronize()
    assert got.shape == (M, N) and got.dtype == torch.float32
    assert _cos(got, want) >= COS_BAR
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    assert torch.equal(got, vit_train.rows_mm(a, b))


# (C, heads, B, Np): 4160 tokens (B=4 x 1040, a partial last panel) at both
# widths, the towers' eval batches, a clip shorter than a panel, the
# Audio-MAE CP batch (three blocks a panel of 64 rows) and HeAR's batches
# (C 1024: the row pass and the GEMM of csrc/vit_rows.cu)
QKV_CASES = [(384, 6, 4, 1040), (768, 12, 4, 1040), (384, 6, 16, 1040), (768, 12, 16, 528),
             (384, 6, 3, 48), (768, 12, 64, 160), (1024, 16, 1, 112), (1024, 16, 16, 112),
             (1024, 16, 64, 112)]


@pytest.mark.gpu
@pytest.mark.parametrize("C,heads,B,Np", QKV_CASES)
def test_vit_qkv_with_ln1_output_on_card(cuda, C, heads, B, Np):
    """vit_qkv against vit_qkv_ref, with and without its LN1 output (the
    same q, k, v either way; LN1(x) against the plain LN1 rows), bitwise
    repeatable, also after the allocator's free memory is filled with NaN,
    one launch a call."""
    p = _vit_params(C, heads, C + B, cuda)
    g = torch.Generator().manual_seed(B * Np)
    x = (torch.randn(B, Np, C, generator=g) * 0.5).to(cuda, torch.bfloat16)
    vit.reset_launch_counts()
    qkv, h = vit.vit_qkv(x, p, return_ln=True)
    plain_qkv = vit.vit_qkv(x, p)
    torch.cuda.synchronize()
    assert vit.launch_counts()["vit_qkv"] == 2
    assert qkv.shape == (3, B, heads, Np, 64) and h.shape == (B * Np, C)
    assert _cos(qkv, vit.vit_qkv_ref(x, p)) >= COS_BAR
    assert _cos(h, vit.ln1_rows(x, p)) >= COS_BAR
    assert torch.equal(qkv, plain_qkv)
    _poison_free_memory()
    again, h2 = vit.vit_qkv(x, p, return_ln=True)
    assert torch.equal(again, qkv) and torch.equal(h2, h)


@pytest.mark.gpu
@pytest.mark.parametrize("C,heads,Np,n_real", VIT_SHAPES)
def test_vit_attn_aligned_hcat_raises_on_card(cuda, C, heads, Np, n_real):
    """K11's aligned_hcat slices v past 3C at head dim 64: a ValueError, no
    launch."""
    p = _vit_params(C, heads, 1, cuda)
    x = torch.zeros(2, Np, C, device=cuda, dtype=torch.bfloat16)
    qkv = vit.vit_qkv(x, p)
    vit.reset_launch_counts()
    with pytest.raises(ValueError, match="aligned_hcat"):
        vit.vit_attn(qkv, p, n_real, mode="aligned_hcat")
    with pytest.raises(ValueError, match="aligned_hcat"):
        vit.fused_vit_attn(x, p, n_real, mode="aligned_hcat")
    assert vit.launch_counts() == dict.fromkeys(vit.launch_counts(), 0)


@pytest.mark.gpu
@pytest.mark.parametrize("C,heads,Np,n_real", VIT_SHAPES)
def test_vit_padded_keys_do_not_leak_on_card(cuda, C, heads, Np, n_real):
    """The real rows of a block do not depend on what the padded rows hold."""
    p = _vit_params(C, heads, 3, cuda)
    g = torch.Generator().manual_seed(5)
    x = (torch.randn(2, Np, C, generator=g) * 0.5).to(cuda, torch.bfloat16)
    x2 = x.clone()
    x2[:, n_real:] = 7.0
    a = vit.fused_vit_block(x, p, n_real)
    b = vit.fused_vit_block(x2, p, n_real)
    torch.cuda.synchronize()
    assert torch.equal(a[:, :n_real], b[:, :n_real])


@pytest.mark.gpu
def test_swin_mlp_eps_unchanged_on_card(cuda):
    """swin_mlp with the swin LN eps (1e-5) still reads as its plain version."""
    p = _params(384, 16, 9, cuda)
    g = torch.Generator().manual_seed(9)
    x = (torch.randn(8, 16, 16, 384, generator=g) * 0.5).to(cuda, torch.bfloat16)
    got, want = swin.swin_mlp(x, p), swin.swin_mlp_ref(x, p)
    torch.cuda.synchronize()
    assert _branch_cos(got, want, x) >= COS_BAR


@pytest.mark.gpu
def test_vit_float32_on_card_raises(cuda):
    p = _vit_params(384, 6, 1, cuda, torch.float32)
    x = torch.zeros(1, 1040, 384, device=cuda)
    for fn in (lambda: vit.vit_qkv(x, p), lambda: vit.fused_vit_block(x, p, 1025),
               lambda: vit.vit_mlp(x, p)):
        with pytest.raises(TypeError):
            fn()


# ---------------------------------------------------------------------------
# the ViT training backward (MAE continued pretraining)
# ---------------------------------------------------------------------------

# (C, heads, Np, n_real, B): the CP shapes (Audio-MAE, OPERA-GT at max_len 256
# and 64) and the operaGT fine-tuning shape; one clip (vit_mlp_bwd's grid
# below the SM count) and 72 clips (runs of several units a block)
VIT_TRAIN_SHAPES = [(768, 12, 160, 154, 4), (384, 6, 320, 308, 4), (384, 6, 80, 77, 4),
                    (384, 6, 1040, 1025, 4), (384, 6, 320, 308, 1), (768, 12, 160, 154, 72),
                    (384, 6, 80, 77, 72)]


@pytest.mark.gpu
@pytest.mark.parametrize("C,heads,Np,n_real,B", VIT_TRAIN_SHAPES)
def test_vit_train_backward_matches_plain_on_card(cuda, C, heads, Np, n_real, B):
    """vit_mlp_bwd and vit_attn_bwd against their plain versions on shared
    inputs: the dh1 / dx branches, every operand row and every gradient leaf
    at 0.99999, two launches bitwise equal, padded rows of dx exactly 0."""
    from heart_murmur_detection_tpu_torch.ops import vit_train

    p = _vit_params(C, heads, C + Np, cuda)
    g = torch.Generator().manual_seed(Np)
    x = (torch.randn(B, Np, C, generator=g) * 0.5).to(cuda, torch.bfloat16)
    h1 = vit.vit_attn_ref(x, p, n_real)
    dy = (torch.randn(B, Np, C, generator=g) * 0.1).to(cuda, torch.bfloat16)
    dy[:, n_real:] = 0  # the caller's y[:, :n_real] slice
    runs = [vit_train.vit_mlp_bwd(h1, dy, p) for _ in range(2)]
    dh1, gm, mrows = vit_train.vit_mlp_bwd_ref(h1, dy, p, rows=True)
    _, r1, _ = vit_train.vit_mlp_bwd_launch(h1, dy, p)
    (d1, g1), (d2, g2) = runs
    torch.cuda.synchronize()
    assert torch.equal(d1, d2) and all(torch.equal(g1[q], g2[q]) for q in g1)
    assert _branch_cos(d1, dh1, dy) >= COS_BAR
    for q, want in gm.items():
        assert _cos(g1[q], want) >= COS_BAR, q
    for name, got, want in zip(("m", "g", "da1"), r1, mrows):
        assert _cos(got, want) >= COS_BAR, name
    assert not d1[:, n_real:].any()
    runs = [vit_train.vit_attn_bwd_launch(x, dh1, p, n_real) for _ in range(2)]
    dx, ga, rows = vit_train.vit_attn_bwd_ref(x, dh1, p, n_real, rows=True)
    (a1, r1, p1), (a2, r2, p2) = runs
    torch.cuda.synchronize()
    assert torch.equal(a1, a2) and torch.equal(p1, p2)
    assert all(torch.equal(u, v) for u, v in zip(r1, r2))
    assert _branch_cos(a1, dx, dh1) >= COS_BAR
    for name, got, want in zip(("h", "o_pre", "dqkv"), r1, rows):
        assert _cos(got, want) >= COS_BAR, name
    assert not a1[:, n_real:].any()
    _, g1 = vit_train.vit_attn_bwd(x, dh1, p, n_real)
    for q, want in ga.items():
        assert _cos(g1[q], want) >= COS_BAR, q


# the phase-14 shapes of chip_smoke.py at their own batches
VIT_BWD_CASES = [(768, 12, 160, 154, 64), (384, 6, 320, 308, 64), (384, 6, 80, 77, 64),
                 (384, 6, 1040, 1025, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("C,heads,Np,n_real,B", VIT_BWD_CASES)
def test_vit_attn_bwd_launches_on_card(cuda, C, heads, Np, n_real, B):
    """vit_attn_bwd at the CP and fine-tuning batches: dx, every operand row
    (dq, dk, dv apart) and every gradient leaf against the plain version,
    the padded key rows of dk and dv exactly 0, two calls bitwise equal
    (also after the allocator's free memory is filled with NaN)."""
    from heart_murmur_detection_tpu_torch.ops import vit_train

    p = _vit_params(C, heads, Np + B, cuda)
    g = torch.Generator().manual_seed(Np + 1)
    x = (torch.randn(B, Np, C, generator=g) * 0.5).to(cuda, torch.bfloat16)
    dh1 = (torch.randn(B, Np, C, generator=g) * 0.1).to(cuda, torch.bfloat16)
    dh1[:, n_real:] = 0  # the caller's y[:, :n_real] slice
    vit_train.reset_launch_counts()
    dx, rows, part = vit_train.vit_attn_bwd_launch(x, dh1, p, n_real)
    want_dx, want_g, want_rows = vit_train.vit_attn_bwd_ref(x, dh1, p, n_real, rows=True)
    torch.cuda.synchronize()
    assert vit_train.launch_counts()["vit_attn_bwd"] == 1
    assert _branch_cos(dx, want_dx, dh1) >= COS_BAR
    for name, got, want in zip(("h", "o_pre"), rows, want_rows):
        assert _cos(got, want) >= COS_BAR, name
    got3, want3 = rows[2].reshape(B, Np, 3, C), want_rows[2].reshape(B, Np, 3, C)
    for i, name in enumerate(("dq", "dk", "dv")):
        assert _cos(got3[:, :, i], want3[:, :, i]) >= COS_BAR, name
    assert not got3[:, n_real:, 1:].any()
    assert not dx[:, n_real:].any()
    _, grads = vit_train.vit_attn_bwd(x, dh1, p, n_real)
    for q, want in want_g.items():
        assert _cos(grads[q], want) >= COS_BAR, q
    _poison_free_memory()
    dx2, rows2, part2 = vit_train.vit_attn_bwd_launch(x, dh1, p, n_real)
    assert torch.equal(dx2, dx) and torch.equal(part2, part)
    assert all(torch.equal(u, v) for u, v in zip(rows2, rows))


@pytest.mark.gpu
@pytest.mark.parametrize("C,heads,Np,n_real", [(768, 12, 160, 154), (384, 6, 80, 77)])
def test_vit_train_block_function_on_card(cuda, C, heads, Np, n_real):
    """fused_vit_block_train on CUDA: the kernel path's gradients reach the
    float32 parameters through the folded bf16 layout (built inside
    autograd) as the plain path's do, leaf by leaf at 0.99999; one launch of
    each backward kernel a block."""
    from heart_murmur_detection_tpu_torch.ops import vit_train

    r = np.random.default_rng(C)
    f = lambda *s: torch.tensor((r.standard_normal(s) * 0.05).astype(np.float32), device=cuda)
    sd = {"norm1.weight": 1 + f(C), "norm1.bias": f(C), "attn.qkv.weight": f(3 * C, C) * 2,
          "attn.qkv.bias": f(3 * C), "attn.proj.weight": f(C, C), "attn.proj.bias": f(C),
          "norm2.weight": 1 + f(C), "norm2.bias": f(C), "mlp.fc1.weight": f(4 * C, C),
          "mlp.fc1.bias": f(4 * C), "mlp.fc2.weight": f(C, 4 * C), "mlp.fc2.bias": f(C)}
    x = (f(4, Np, C) * 10).to(torch.bfloat16)
    w_out = f(4, n_real, C)
    grads = {}
    for impl in ("kernel", "plain"):
        leaves = {n: v.clone().requires_grad_() for n, v in sd.items()}
        xi = x.clone().requires_grad_()
        p = vit.vit_block_layout(lambda n: leaves[n], heads, torch.bfloat16)
        vit_train.reset_launch_counts()
        y = vit_train.fused_vit_block_train(xi, p, n_real, impl)
        g = torch.autograd.grad((y[:, :n_real].float() * w_out).sum(), [xi, *leaves.values()])
        grads[impl] = dict(zip(["x", *leaves], g))
        want = 1 if impl == "kernel" else 0
        assert vit_train.launch_counts() == {"vit_attn_bwd": want, "vit_mlp_bwd": want}
    torch.cuda.synchronize()
    for n, want in grads["plain"].items():
        got = grads["kernel"][n]
        assert got.dtype == want.dtype and got.shape == want.shape, n
        assert _cos(got, want) >= COS_BAR, n


@pytest.mark.gpu
def test_vit_train_float32_on_card_raises(cuda):
    from heart_murmur_detection_tpu_torch.ops import vit_train

    p = _vit_params(384, 6, 1, cuda, torch.float32)
    x = torch.zeros(1, 320, 384, device=cuda)
    for fn in (lambda: vit_train.vit_mlp_bwd(x, x, p), lambda: vit_train.vit_attn_bwd(x, x, p)):
        with pytest.raises(TypeError):
            fn()


# ---------------------------------------------------------------------------
# the fused log-mel kernel and the resampler (the extraction path's frontend)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("B,sec", [(16, 10.0), (64, 10.0), (16, 32.0), (64, 32.0), (16, None),
                                   (1, 0.032), (1, 10.0), (5, None)])
def test_logmel_matches_plain_on_card(cuda, B, sec):
    """The normalised mel within 1e-4 of the plain version, frame counts
    exact, two launches bitwise equal (sec None: a ragged 3-32 s batch;
    0.032 s: N = 512, two frames)."""
    from heart_murmur_detection_tpu_torch.bench.logmel_time import clips
    from heart_murmur_detection_tpu_torch.ops import mel

    w, lens = clips(B, sec, seed=B)
    wav, lengths = torch.from_numpy(w).to(cuda), torch.from_numpy(lens).to(cuda)
    before = mel.launch_counts()["logmel"]
    got, nf = mel.mel_frontend_fused(wav, lengths)
    again, _ = mel.mel_frontend_fused(wav, lengths)
    want, nf_p = mel.mel_frontend_fused(wav, lengths, impl="plain")
    torch.cuda.synchronize()
    assert mel.launch_counts()["logmel"] == before + 2
    assert torch.equal(nf, nf_p) and got.shape == want.shape
    assert torch.equal(got, again)
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.gpu
def test_logmel_float32_precision_on_card(cuda):
    """Against a float64 evaluation of the same function, the kernel's error
    is at most 4x the plain float32 version's: a single-pass TF32 or bf16
    product would be orders of magnitude worse on the bins far from a
    low-level tone."""
    from heart_murmur_detection_tpu_torch.bench.logmel_time import precision

    p = precision()
    assert p["kernel_err"] <= 4 * p["plain_err"], p


@pytest.mark.gpu
def test_logmel_rejects_what_it_does_not_take(cuda):
    from heart_murmur_detection_tpu_torch.ops import mel

    with pytest.raises(TypeError):
        mel.fused_logmel(torch.zeros(1, 1024, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        mel.fused_logmel(torch.zeros(1, 1000, device=cuda))
    with pytest.raises(ValueError):
        mel.fused_logmel(torch.zeros(1, 1024, device=cuda), n_mels=128)


@pytest.mark.gpu
@pytest.mark.parametrize("up,down", [(4, 1), (8, 1), (3, 2), (160, 441)])
def test_resampler_matches_scipy_on_card(cuda, up, down):
    """The polyphase matrix product stays float32 on the card at PyTorch's
    default flags (cuDNN's TF32 on, the matmul's off): a TF32 path would
    miss 3e-5 by orders of magnitude. The fixture restores the flags."""
    from scipy.signal import resample_poly

    from heart_murmur_detection_tpu_torch.ops.resample import resample_poly_device

    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False

    x = np.random.default_rng(0).standard_normal((16, 32 * 4000)).astype(np.float32)
    got = resample_poly_device(torch.from_numpy(x).to(cuda), up, down).cpu().numpy()
    want = np.stack([resample_poly(r, up, down) for r in x]).astype(np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 3e-5


# ---------------------------------------------------------------------------
# HeAR's ViT-L geometry (C 1024, 16 heads of 64, hidden 4096, 97 tokens
# padded to 112): the TPU kernels K6 / K7 that the HeAR extraction runs
# ---------------------------------------------------------------------------

HEAR = (1024, 16, 112, 97)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 16, 64])
@pytest.mark.parametrize("fast_softmax", [False, True])
def test_hear_kernels_match_plain_on_card(cuda, B, fast_softmax):
    """vit_qkv (and its LN1 output), vit_attn, vit_proj and vit_mlp at C =
    1024 against their plain versions, the padded keys masked, each bitwise
    equal on a second launch, one launch a call."""
    C, heads, Np, n_real = HEAR
    p = _vit_params(C, heads, C + B, cuda)
    g = torch.Generator().manual_seed(B)
    x = (torch.randn(B, Np, C, generator=g) * 0.5).to(cuda, torch.bfloat16)
    x[:, n_real:] = 0.0
    mode = "fast" if fast_softmax else "stable"
    vit.reset_launch_counts()
    qkv, h = vit.vit_qkv(x, p, return_ln=True)
    qkv_ref = vit.vit_qkv_ref(x, p)
    o = vit.vit_attn(qkv_ref, p, n_real, mode)
    o_ref = vit.vit_attn_core_ref(qkv_ref, p, n_real, mode)
    h1 = vit.vit_proj(o_ref, x, p)
    h1_ref = vit.vit_proj_ref(o_ref, x, p)
    y, y_ref = vit.vit_mlp(h1_ref, p), vit.vit_mlp_ref(h1_ref, p)
    torch.cuda.synchronize()
    assert vit.launch_counts() == {"vit_qkv": 1, "vit_attn": 1, "vit_proj": 1, "vit_mlp": 1}
    assert qkv.shape == (3, B, heads, Np, 64) and o.shape == (B, Np, C)
    assert _cos(qkv, qkv_ref) >= COS_BAR
    assert _cos(h, vit.ln1_rows(x, p)) >= COS_BAR
    assert _cos(o, o_ref) >= COS_BAR
    assert _branch_cos(h1, h1_ref, x) >= COS_BAR
    assert _branch_cos(y, y_ref, h1_ref) >= COS_BAR
    assert torch.equal(vit.vit_qkv(x, p), qkv)
    assert torch.equal(vit.vit_attn(qkv_ref, p, n_real, mode), o)
    assert torch.equal(vit.vit_proj(o_ref, x, p), h1)
    assert torch.equal(vit.vit_mlp(h1_ref, p), y)


@pytest.mark.gpu
def test_hear_padded_keys_do_not_leak_on_card(cuda):
    """At 112 tokens the key tiles end past Np: the real rows of a block do
    not depend on what the padded rows hold."""
    C, heads, Np, n_real = HEAR
    p = _vit_params(C, heads, 7, cuda)
    g = torch.Generator().manual_seed(7)
    x = (torch.randn(2, Np, C, generator=g) * 0.5).to(cuda, torch.bfloat16)
    x2 = x.clone()
    x2[:, n_real:] = 7.0
    for mode in ("stable", "fast"):
        a = vit.fused_vit_block(x, p, n_real, mode)
        b = vit.fused_vit_block(x2, p, n_real, mode)
        torch.cuda.synchronize()
        assert torch.equal(a[:, :n_real], b[:, :n_real])


@pytest.mark.gpu
def test_hear_forward_on_card(cuda):
    """A full-width HeAR forward at B=2 on the kernels: 24 launches of each
    ViT kernel, finite, and each clip's features close to the plain bf16
    flow on the card (chip_smoke.py's HEAR_PLAIN_BAR: the two flows differ
    in sum order only, ~0.99994 apart after 24 ViT-L blocks)."""
    from heart_murmur_detection_tpu_torch.models import hear
    from heart_murmur_detection_tpu_torch.models.vit_fused import hear_forward_fused

    model = hear.HeAREncoder()
    hear.init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    wav = (torch.randn(2, 32000, generator=torch.Generator().manual_seed(1)) * 0.2).to(cuda)
    vit.reset_launch_counts()
    got = hear_forward_fused(model, wav, torch.bfloat16, fast_softmax=True)
    torch.cuda.synchronize()
    assert vit.launch_counts() == dict.fromkeys(("vit_qkv", "vit_attn", "vit_proj", "vit_mlp"), 24)
    want = hear_forward_fused(model, wav, torch.bfloat16, fast_softmax=True, impl="plain")
    assert got.shape == (2, 512) and bool(got.isfinite().all())
    assert min(_cos(got[i], want[i]) for i in range(2)) >= 0.99988
