"""The CUDA swin kernels of heart_murmur_detection_tpu_torch: the build and
its ctypes binding (CPU), and, on a card only, each kernel against its
plain torch version at the four HTS-AT stage geometries.

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
from heart_murmur_detection_tpu_torch.ops import _build, swin

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
    for name, argtypes in _build._SIGNATURES.items():
        assert argtypes[-1] is ctypes.c_void_p, name  # the stream
        n_ptr = 10 if name == "swin_attn_launch" else 8
        assert all(a is ctypes.c_void_p for a in argtypes[:n_ptr]), name
        assert all(a is ctypes.c_int for a in argtypes[n_ptr:-1]), name


def test_build_targets_sm90a_and_hashes_sources():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    srcs = {p.rsplit("/", 1)[-1] for p in _build._sources()}
    assert {"swin_attn.cu", "swin_mlp.cu", "swin_common.cuh"} <= srcs
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
