"""ops/swin.py (the port's swin entry points, plain versions on the CPU)
against the JAX Pallas entry points of ops/pallas_swin.py run in interpret
mode, on the same numpy weights and inputs, plus the CPU dispatch rules.
The CUDA kernels themselves are checked on a card by test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.models.htsat import (
    _relative_position_index,
    _shift_attn_mask,
)
from heart_murmur_detection_tpu.ops import pallas_swin as ps
from heart_murmur_detection_tpu_torch.ops import swin

@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the test run shares the cores among its xdist
    workers, and torch's default of one spinning thread per core starves
    them (the port's tests took 4x the CPU time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# the bound of test_pallas_swin.py::test_split_block_matches_flax
ATOL, RTOL = 3e-5, 1e-4


def _block(C, heads, seed, scale=0.05):
    """One block's weights as a flax param dict and as the port's
    reference-named state_dict, plus its gathered bias."""
    r = np.random.default_rng(seed)
    f = lambda *s: (r.standard_normal(s) * scale).astype(np.float32)
    p = {
        "norm1": {"scale": 1 + f(C), "bias": f(C)},
        "attn": {
            "qkv": {"kernel": f(C, 3 * C), "bias": f(3 * C)},
            "proj": {"kernel": f(C, C), "bias": f(C)},
            "relative_position_bias_table": f(15 * 15, heads) * 10,
        },
        "norm2": {"scale": 1 + f(C), "bias": f(C)},
        "mlp": {
            "fc1": {"kernel": f(C, 4 * C), "bias": f(4 * C)},
            "fc2": {"kernel": f(4 * C, C), "bias": f(C)},
        },
    }
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    sd = {
        "norm1.weight": t(p["norm1"]["scale"]), "norm1.bias": t(p["norm1"]["bias"]),
        "attn.qkv.weight": t(p["attn"]["qkv"]["kernel"].T),
        "attn.qkv.bias": t(p["attn"]["qkv"]["bias"]),
        "attn.proj.weight": t(p["attn"]["proj"]["kernel"].T),
        "attn.proj.bias": t(p["attn"]["proj"]["bias"]),
        "norm2.weight": t(p["norm2"]["scale"]), "norm2.bias": t(p["norm2"]["bias"]),
        "mlp.fc1.weight": t(p["mlp"]["fc1"]["kernel"].T),
        "mlp.fc1.bias": t(p["mlp"]["fc1"]["bias"]),
        "mlp.fc2.weight": t(p["mlp"]["fc2"]["kernel"].T),
        "mlp.fc2.bias": t(p["mlp"]["fc2"]["bias"]),
    }
    table = p["attn"]["relative_position_bias_table"]
    bias = table[_relative_position_index(8, 8).reshape(-1)].reshape(64, 64, heads)
    bias = np.ascontiguousarray(bias.transpose(2, 0, 1))
    return p, sd, bias


def _x(B, H, W, C, seed=0):
    return (np.random.default_rng(seed).standard_normal((B, H, W, C)) * 0.5).astype(np.float32)


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _jax_block(x, p, bias, shift, mask, entry, **kw):
    """JAX entry point with its own roll convention: H roll outside, W roll
    in the kernel (roll_w), both undone on the output."""
    xs = jnp.roll(jnp.asarray(x), -shift, axis=1) if shift else jnp.asarray(x)
    out = entry(xs, p, jnp.asarray(bias), None if mask is None else jnp.asarray(mask),
                num_heads=bias.shape[0], interpret=True, roll_w=shift, **kw)
    return jnp.roll(out, shift, axis=1) if shift else out


GEOMS = [  # (C, heads, H, W, shift)
    (48, 2, 16, 16, 0),
    (48, 2, 16, 16, 4),
    (768, 32, 8, 8, 0),
]


@pytest.mark.parametrize("C,heads,H,W,shift", GEOMS)
@pytest.mark.parametrize("entry", ["block", "split"])
def test_block_f32_matches_jax(C, heads, H, W, shift, entry):
    p, sd, bias = _block(C, heads, seed=C + shift)
    x = _x(2, H, W, C, seed=1)
    mask = _shift_attn_mask(H, W, 8, shift) if shift else None
    jfn = ps.fused_swin_block if entry == "block" else ps.fused_swin_block_split
    want = np.asarray(_jax_block(x, p, bias, shift, mask, jfn))
    pb = swin.prep_block(sd, heads, torch.from_numpy(bias), torch.float32)
    tfn = swin.fused_swin_block if entry == "block" else swin.fused_swin_block_split
    got = tfn(torch.from_numpy(x), pb, None if mask is None else torch.from_numpy(mask), shift)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("fast_softmax", [False, True])
def test_pair_f32_matches_jax(fast_softmax):
    C, heads, H = 48, 2, 16
    pa, sda, ba = _block(C, heads, seed=1)
    pb_, sdb, bb = _block(C, heads, seed=2)
    mask = _shift_attn_mask(H, H, 8, 4)
    x = _x(2, H, H, C, seed=3)
    want = np.asarray(ps.fused_swin_pair(
        jnp.asarray(x), pa, pb_, jnp.asarray(ba), jnp.asarray(bb), jnp.asarray(mask),
        num_heads=heads, shift=4, interpret=True, fast_softmax=fast_softmax,
    ))
    got = swin.fused_swin_pair(
        torch.from_numpy(x),
        swin.prep_block(sda, heads, torch.from_numpy(ba), torch.float32),
        swin.prep_block(sdb, heads, torch.from_numpy(bb), torch.float32),
        torch.from_numpy(mask), 4, fast_softmax=fast_softmax,
    )
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("C,heads,H,W,shift", GEOMS)
def test_block_bf16_flow_matches_jax(C, heads, H, W, shift):
    """bf16 activations and matmuls, f32 LN/softmax/GELU on both sides
    (cosine bound of test_pallas_swin.py::test_pair_bf16_activation_maps)."""
    p, sd, bias = _block(C, heads, seed=7 + C)
    x = _x(2, H, W, C, seed=4)
    mask = _shift_attn_mask(H, W, 8, shift) if shift else None
    want = _jax_block(x.astype(jnp.bfloat16), p, bias, shift, mask, ps.fused_swin_block,
                      mm_dtype=jnp.bfloat16)
    pb = swin.prep_block(sd, heads, torch.from_numpy(bias), torch.bfloat16)
    got = swin.fused_swin_block(
        torch.from_numpy(x).to(torch.bfloat16), pb,
        None if mask is None else torch.from_numpy(mask), shift,
    )
    assert got.dtype == torch.bfloat16
    assert _cos(got.float().numpy(), np.asarray(want, np.float32)) >= 0.999


def test_head_padding_and_layout():
    """qkv rows are padded per head from hd=24 to 32 with zeros; proj keeps
    the (out, in) layout."""
    _, sd, bias = _block(48, 2, seed=5)
    pb = swin.prep_block(sd, 2, torch.from_numpy(bias), torch.bfloat16)
    assert pb.w_qkv.shape == (3 * 2 * 32, 48) and pb.w_qkv.dtype == torch.bfloat16
    w = pb.w_qkv.float().reshape(3, 2, 32, 48)
    assert (w[:, :, 24:] == 0).all()
    np.testing.assert_array_equal(
        w[:, :, :24].reshape(144, 48).numpy(),
        sd["attn.qkv.weight"].to(torch.bfloat16).float().numpy(),
    )
    assert (pb.b_qkv.reshape(3, 2, 32)[:, :, 24:] == 0).all()
    assert pb.bias.dtype == torch.float32 and pb.bias.shape == (2, 64, 64)


def test_cpu_dispatch_runs_plain_without_launching():
    _, sd, bias = _block(48, 2, seed=6)
    pb = swin.prep_block(sd, 2, torch.from_numpy(bias), torch.float32)
    x = torch.from_numpy(_x(1, 16, 16, 48))
    before = swin.launch_counts()
    got = swin.fused_swin_block(x, pb)
    want = swin.fused_swin_block(x, pb, impl="plain")
    assert torch.equal(got, want)
    assert swin.launch_counts() == before
    with pytest.raises(ValueError):
        swin.fused_swin_block(x, pb, impl="triton")
    with pytest.raises(ValueError):
        swin.fused_swin_pair(x, pb, pb, None, 0)
