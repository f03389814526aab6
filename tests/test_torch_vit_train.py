"""ops/vit_train.py (the port's training ViT block, plain versions on the
CPU) against the JAX fused_vit_block_train of ops/pallas_vit_train.py in
interpret mode, in both of its weight-gradient modes ("acc" and "emit"),
and against jax.grad of the flax ViTBlock, on the same numpy weights and
inputs; the explicit plain backward against torch autograd; padded rows;
the CPU dispatch rules. The CUDA kernels themselves are checked on a card
by test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.models.vit_mae import ViTBlock as JaxViTBlock
from heart_murmur_detection_tpu.ops.pallas_vit import pad_tokens as jax_pad_tokens
from heart_murmur_detection_tpu.ops.pallas_vit_train import fused_vit_block_train as jax_block
from heart_murmur_detection_tpu_torch.ops import vit, vit_train


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the test run shares the cores among its xdist
    workers (see test_torch_swin.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


G_ATOL, G_RTOL = 2e-4, 2e-3  # test_pallas_vit_train.py's bar for y and every leaf
COS_BAR = 0.99999  # bf16: the port's rounding points against the JAX body's
B, N, C, HEADS = 2, 40, 128, 4  # 40 tokens pad to 48: padded rows and keys
# port state_dict key -> (flax ViTBlock path, transposed)
NAMES = {
    "norm1.weight": (("norm1", "scale"), False), "norm1.bias": (("norm1", "bias"), False),
    "attn.qkv.weight": (("attn_qkv", "kernel"), True), "attn.qkv.bias": (("attn_qkv", "bias"), False),
    "attn.proj.weight": (("attn_proj", "kernel"), True),
    "attn.proj.bias": (("attn_proj", "bias"), False),
    "norm2.weight": (("norm2", "scale"), False), "norm2.bias": (("norm2", "bias"), False),
    "mlp.fc1.weight": (("mlp_fc1", "kernel"), True), "mlp.fc1.bias": (("mlp_fc1", "bias"), False),
    "mlp.fc2.weight": (("mlp_fc2", "kernel"), True), "mlp.fc2.bias": (("mlp_fc2", "bias"), False),
}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _setup():
    """A flax ViTBlock tree with non-trivial norms and biases, an input of
    B clips of N tokens, and the weights of <y[:, :N], w_out>."""
    r = np.random.default_rng(0)
    g = lambda *s: (r.standard_normal(s) * 0.05).astype(np.float32)
    p = {
        "norm1": {"scale": 1.0 + g(C), "bias": g(C)},
        "attn_qkv": {"kernel": g(C, 3 * C) * 4, "bias": g(3 * C)},
        "attn_proj": {"kernel": g(C, C), "bias": g(C)},
        "norm2": {"scale": 1.0 + g(C), "bias": g(C)},
        "mlp_fc1": {"kernel": g(C, 4 * C), "bias": g(4 * C)},
        "mlp_fc2": {"kernel": g(4 * C, C), "bias": g(C)},
    }
    x = (r.standard_normal((B, N, C)) * 2).astype(np.float32)
    w_out = r.standard_normal((B, N, C)).astype(np.float32)
    return p, x, w_out


def _sd(p):
    return {k: torch.from_numpy(np.ascontiguousarray(_get(p, path).T if t else _get(p, path)))
            for k, (path, t) in NAMES.items()}


def _port(p, x, w_out, mm, impl):
    """Port block output (real rows) and the gradients of <y[:, :N], w_out>
    with respect to x and the float32 parameters (state_dict names)."""
    leaves = {k: v.clone().requires_grad_() for k, v in _sd(p).items()}
    xp, n_real = vit.pad_tokens(torch.from_numpy(x), 16)
    xi = xp.to(mm).requires_grad_()
    bp = vit.vit_block_layout(lambda k: leaves[k], HEADS, mm)
    y = vit_train.fused_vit_block_train(xi, bp, n_real, impl)
    g = torch.autograd.grad((y[:, :n_real].float() * torch.from_numpy(w_out)).sum(),
                            [xi, *leaves.values()])
    grads = dict(zip(["x", *leaves], g))
    return y[:, :n_real].detach().float().numpy(), grads


def _jax(p, x, w_out, mm, mode):
    """JAX fused block (interpret mode) output and the same gradients, the
    parameter leaves in the port's names and layouts."""
    act = jnp.bfloat16 if mm == "bf16" else jnp.float32
    mmd = jnp.bfloat16 if mm == "bf16" else jnp.float32

    def f(params, xx):
        xp, nr = jax_pad_tokens(xx.astype(act), 16)
        y = jax_block(xp, params, nr, num_heads=HEADS, q_chunk=64, mm_dtype=mmd, mode=mode,
                      interpret=True)[:, :N]
        return jnp.sum(y.astype(jnp.float32) * w_out), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(p, x)
    grads = {k: np.asarray(_get(gp, path)).T if t else np.asarray(_get(gp, path))
             for k, (path, t) in NAMES.items()}
    grads["x"] = np.asarray(gx)
    return np.asarray(y.astype(jnp.float32)), grads


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("mode", ["acc", "emit"])
def test_plain_matches_jax_float32(mode):
    """f32: y and every gradient leaf at the JAX test's bar, in both modes."""
    p, x, w_out = _setup()
    y, g = _port(p, x, w_out, torch.float32, "plain")
    jy, jg = _jax(p, x, w_out, "f32", mode)
    np.testing.assert_allclose(y, jy, atol=G_ATOL, rtol=G_RTOL)
    for k, want in jg.items():
        got = g[k].float().numpy()
        if k == "x":
            got = got[:, :N]
        np.testing.assert_allclose(got, want, atol=G_ATOL, rtol=G_RTOL, err_msg=k)


@pytest.mark.parametrize("mode", ["acc", "emit"])
def test_plain_matches_jax_bf16(mode):
    """bf16: the port's plain path rounds where the JAX bodies round; y and
    every leaf by cosine against the JAX bf16 run."""
    p, x, w_out = _setup()
    y, g = _port(p, x, w_out, torch.bfloat16, "plain")
    jy, jg = _jax(p, x, w_out, "bf16", mode)
    assert _cos(y - x, jy - x) >= COS_BAR
    for k, want in jg.items():
        got = g[k].float().numpy()
        if k == "x":
            got = got[:, :N]
        assert _cos(got, want) >= COS_BAR, (k, _cos(got, want))


def test_gradients_through_the_fold_match_flax_vitblock():
    """The q scale folded into the weights is differentiated back to the
    flax ViTBlock's parameters: jax.grad of the plain flax block."""
    p, x, w_out = _setup()
    _, g = _port(p, x, w_out, torch.float32, "plain")
    block = JaxViTBlock(dim=C, num_heads=HEADS)

    def f(params, xx):
        return jnp.sum(block.apply({"params": params}, xx) * w_out)

    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(p, x)
    np.testing.assert_allclose(g["x"][:, :N].numpy(), np.asarray(gx), atol=G_ATOL, rtol=G_RTOL)
    for k, (path, t) in NAMES.items():
        want = np.asarray(_get(gp, path))
        np.testing.assert_allclose(g[k].numpy(), want.T if t else want, atol=G_ATOL,
                                   rtol=G_RTOL, err_msg=k)


def test_plain_backward_is_autograd_of_plain_forward():
    """In float32 the explicit plain backward is the exact gradient of the
    plain forward: torch autograd of it agrees to float32 roundoff."""
    p, x, w_out = _setup()
    y1, g1 = _port(p, x, w_out, torch.float32, "plain")
    y2, g2 = _port(p, x, w_out, torch.float32, "autograd")
    np.testing.assert_array_equal(y1, y2)
    for k in g1:
        np.testing.assert_allclose(g1[k].numpy(), g2[k].numpy(), atol=1e-5, rtol=1e-4, err_msg=k)


def test_padded_rows_do_not_leak():
    """dx is exactly 0 on padded rows, and what the padded rows hold changes
    neither the real rows nor any gradient."""
    p, x, w_out = _setup()
    leaves = {k: v.clone().requires_grad_() for k, v in _sd(p).items()}
    out = []
    for fill in (0.0, 7.0):
        xp, n_real = vit.pad_tokens(torch.from_numpy(x), 16)
        xp[:, n_real:] = fill
        xi = xp.requires_grad_()
        bp = vit.vit_block_layout(lambda k: leaves[k], HEADS, torch.float32)
        y = vit_train.fused_vit_block_train(xi, bp, n_real, "plain")
        g = torch.autograd.grad((y[:, :n_real] * torch.from_numpy(w_out)).sum(),
                                [xi, *leaves.values()])
        assert not g[0][:, n_real:].any()
        out.append((y[:, :n_real], g))
    (y0, g0), (y1, g1) = out
    torch.testing.assert_close(y0, y1, atol=1e-6, rtol=1e-6)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_rows_mm_plain_is_the_jax_dh_product():
    """rows_mm, the test-only entry to the token-row product of
    vit_attn_bwd's do and dh launches (A K-major, B the (out, in) weight read
    as (K, N)), on the CPU is the float32 product of the bf16 operands, as
    the JAX body's `jnp.dot(..., preferred_element_type=f32)` of dqkv and
    W_qkv; no path's launch count moves."""
    r = np.random.default_rng(4)
    a = torch.from_numpy(r.standard_normal((96, 3 * C)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(r.standard_normal((3 * C, C)).astype(np.float32)).to(torch.bfloat16)
    vit_train.reset_launch_counts()
    got = vit_train.rows_mm(a, w)
    want = jnp.dot(jnp.asarray(a.float().numpy()).astype(jnp.bfloat16),
                   jnp.asarray(w.float().numpy()).astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    assert got.dtype == torch.float32 and got.shape == (96, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)
    assert set(vit_train.launch_counts().values()) == {0}


def test_cpu_dispatch_runs_plain_and_counts_nothing():
    p, x, w_out = _setup()
    vit_train.reset_launch_counts()
    y1, g1 = _port(p, x, w_out, torch.bfloat16, "kernel")
    y2, g2 = _port(p, x, w_out, torch.bfloat16, "plain")
    np.testing.assert_array_equal(y1, y2)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k
    assert vit_train.launch_counts() == dict.fromkeys(
        ("vit_attn_bwd", "vit_mlp_bwd", "vit_attn_bwd_f32", "vit_mlp_bwd_f32"), 0)
    with pytest.raises(ValueError, match="impl"):
        vit_train.fused_vit_block_train(torch.zeros(1, 16, C), None, None, "fast")
