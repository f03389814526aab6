"""The CUDA swin kernels of heart_murmur_detection_tpu_torch: the build and
its ctypes binding (CPU), and, on a card only, each kernel against its
plain torch version at the HTS-AT stage geometries: the eval kernels at the
four stages, the training kernels (forward with DropPath multipliers, both
backward halves, the weight-gradient products and the ordered reduction)
at stages 0-2.

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
from heart_murmur_detection_tpu_torch.ops import _build, swin, swin_train

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
    would cut a 64-bit pointer)."""
    n_ptrs = {"swin_attn_launch": 11, "swin_mlp_launch": 9, "swin_attn_bwd_launch": 16,
              "swin_mlp_bwd_launch": 14, "swin_wgrad_launch": 3, "swin_reduce_launch": 2}
    assert set(_build._SIGNATURES) == set(n_ptrs)
    for name, argtypes in _build._SIGNATURES.items():
        assert argtypes[-1] is ctypes.c_void_p, name  # the stream
        n_ptr = n_ptrs[name]
        assert all(a is ctypes.c_void_p for a in argtypes[:n_ptr]), name
        assert all(a is ctypes.c_int for a in argtypes[n_ptr:-1]), name


def test_build_targets_sm90a_and_hashes_sources():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    srcs = {p.rsplit("/", 1)[-1] for p in _build._sources()}
    assert {"swin_attn.cu", "swin_mlp.cu", "swin_common.cuh", "swin_attn_bwd.cu",
            "swin_mlp_bwd.cu", "swin_wgrad.cu"} <= srcs
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
@pytest.mark.parametrize("B", [4, 72])  # clustered and single-block launches at C >= 384
def test_kernels_match_plain_on_card(cuda, C, heads, H, shift, fast_softmax, B):
    p = _params(C, heads, C, cuda)
    mask = torch.from_numpy(_shift_attn_mask(H, H, 8, shift)).to(cuda) if shift else None
    g = torch.Generator().manual_seed(C)
    x = (torch.randn(B, H, H, C, generator=g) * 0.5).to(cuda, torch.bfloat16)
    n0 = swin.launch_counts()
    for s, m in ((0, None), (shift, mask)):
        got = swin.swin_attn(x, p, m, s, fast_softmax)
        want = swin.swin_attn_ref(x, p, m, s, fast_softmax)
        torch.cuda.synchronize()
        assert _branch_cos(got, want, x) >= COS_BAR
    got, want = swin.swin_mlp(x, p), swin.swin_mlp_ref(x, p)
    torch.cuda.synchronize()
    assert _branch_cos(got, want, x) >= COS_BAR
    n1 = swin.launch_counts()
    assert n1["swin_attn"] - n0["swin_attn"] == 2 and n1["swin_mlp"] - n0["swin_mlp"] == 1


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
def test_train_kernels_match_plain_on_card(cuda, C, heads, H, shift, s):
    """Forward halves with DropPath multipliers (a 0 and a 1/0.9 among them)
    and both backward halves against their plain versions: the branch of
    each forward output, dx's branch (dx - dh1) and every gradient leaf at a
    cosine of 0.99999; two launches give bitwise-equal results."""
    shift = shift * s
    B = 4
    p = _params(C, heads, C + 1, cuda)
    mask = torch.from_numpy(_shift_attn_mask(H, H, 8, shift)).to(cuda) if shift else None
    g = torch.Generator().manual_seed(C + 2)
    x = (torch.randn(B, H, H, C, generator=g) * 0.5).to(cuda, torch.bfloat16)
    dy = (torch.randn(B, H, H, C, generator=g) * 0.1).to(cuda, torch.bfloat16)
    k = torch.tensor([0.0, 1 / 0.9, 1.0, 1 / 0.9], device=cuda)
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


@pytest.mark.gpu
@pytest.mark.parametrize("n,M,N", [(4096 * 4, 384, 96), (1024, 96, 1536), (64, 32, 32)])
def test_wgrad_and_reduce_match_plain_on_card(cuda, n, M, N):
    g = torch.Generator().manual_seed(n + M)
    a = torch.randn(n, M, generator=g).to(cuda, torch.bfloat16)
    b = torch.randn(n, N, generator=g).to(cuda, torch.bfloat16)
    got = swin_train.swin_wgrad(a, b)
    want = swin_train.wgrad_ref(a, b)
    torch.cuda.synchronize()
    assert _cos(got, want) >= COS_BAR
    assert torch.equal(got, swin_train.swin_wgrad(a, b))
    parts = torch.randn(7, 1000, generator=g).to(cuda)
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
