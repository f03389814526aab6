"""ops/swin_train.py (the port's training swin block, plain versions on the
CPU) against the JAX fused_swin_block_train of ops/pallas_swin_train.py in
interpret mode and jax.grad, on the same numpy weights and inputs; the
explicit plain backward against torch autograd of the plain forward; the
relative-position gather's fixed-order backward; the CPU dispatch rules.
The CUDA kernels themselves are checked on a card by test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.models.htsat import _relative_position_index, _shift_attn_mask
from heart_murmur_detection_tpu.ops.pallas_swin_train import fused_swin_block_train as jax_block
from heart_murmur_detection_tpu_torch.ops import swin, swin_train


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the test run shares the cores among its xdist
    workers (see test_torch_swin.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# the bounds of test_htsat_train_fused.py (forward) and its gradient leaves
Y_RTOL, Y_ATOL = 1e-4, 1e-5
G_RTOL, G_ATOL = 5e-4, 5e-5
COS_BAR = 0.99999  # bf16: the port's rounding points against the JAX body's
NAMES = {  # port state_dict key -> (flax path, transposed)
    "norm1.weight": (("norm1", "scale"), False), "norm1.bias": (("norm1", "bias"), False),
    "attn.qkv.weight": (("attn", "qkv", "kernel"), True),
    "attn.qkv.bias": (("attn", "qkv", "bias"), False),
    "attn.proj.weight": (("attn", "proj", "kernel"), True),
    "attn.proj.bias": (("attn", "proj", "bias"), False),
    "norm2.weight": (("norm2", "scale"), False), "norm2.bias": (("norm2", "bias"), False),
    "mlp.fc1.weight": (("mlp", "fc1", "kernel"), True),
    "mlp.fc1.bias": (("mlp", "fc1", "bias"), False),
    "mlp.fc2.weight": (("mlp", "fc2", "kernel"), True),
    "mlp.fc2.bias": (("mlp", "fc2", "bias"), False),
}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _setup(masked):
    """test_pallas_swin_train.py's setup: B=2, 16x16, C=32, heads 4 (hd 8,
    padded to 32), window 8, k1/k2 with a zero."""
    B, H, W, C, heads = 2, 16, 16, 32, 4
    r = np.random.default_rng(0)
    x = r.standard_normal((B, H, W, C)).astype(np.float32)
    rp = np.random.default_rng(1)
    g = lambda *s: (rp.standard_normal(s) * 0.05).astype(np.float32)
    p = {
        "norm1": {"scale": 1.0 + g(C), "bias": g(C)},
        "attn": {"qkv": {"kernel": g(C, 3 * C), "bias": g(3 * C)},
                 "proj": {"kernel": g(C, C), "bias": g(C)}},
        "norm2": {"scale": 1.0 + g(C), "bias": g(C)},
        "mlp": {"fc1": {"kernel": g(C, 4 * C), "bias": g(4 * C)},
                "fc2": {"kernel": g(4 * C, C), "bias": g(C)}},
    }
    bias = (r.standard_normal((heads, 64, 64)) * 0.02).astype(np.float32)
    mask = _shift_attn_mask(H, W, 8, 4) if masked else None
    k1 = np.asarray([[0.0], [1.0 / 0.9]], np.float32)
    k2 = np.asarray([[1.0 / 0.9], [1.0]], np.float32)
    w_out = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    return x, p, bias, mask, k1, k2, heads, w_out


def _jax(x, p, bias, mask, k1, k2, heads, w_out, mm):
    """JAX block output and the gradients of <y, w_out> (x, params, bias)."""
    act = jnp.bfloat16 if mm == "bf16" else jnp.float32
    mmd = jnp.bfloat16 if mm == "bf16" else jnp.float32
    m = None if mask is None else jnp.asarray(mask)

    def fwd(x, p, bias):
        return jax_block(x.astype(act), p, bias, m, jnp.asarray(k1), jnp.asarray(k2),
                         window=8, num_heads=heads, interpret=True, mm_dtype=mmd)

    def loss(x, p, bias):
        return jnp.vdot(fwd(x, p, bias).astype(jnp.float32), jnp.asarray(w_out))

    y = jax.jit(fwd)(x, p, bias)
    gx, gp, gb = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(x, p, bias)
    grads = {k: _get(gp, path).T if t else _get(gp, path) for k, (path, t) in NAMES.items()}
    return np.asarray(y.astype(jnp.float32)), np.asarray(gx), np.asarray(gb), grads


def _port(x, p, bias, mask, k1, k2, heads, w_out, mm, impl="kernel"):
    """The port's block output and the gradients of <y, w_out>."""
    sd = {k: torch.tensor(_get(p, path).T if t else _get(p, path)).requires_grad_()
          for k, (path, t) in NAMES.items()}
    bt = torch.tensor(bias).requires_grad_()
    xt = torch.tensor(x).requires_grad_()
    dt = torch.bfloat16 if mm == "bf16" else torch.float32
    blk = swin.block_layout(lambda k: sd[k], heads, bt, dt)
    m = None if mask is None else torch.from_numpy(mask)
    y = swin_train.fused_swin_block_train(
        xt.to(dt), blk, m, 0, torch.from_numpy(k1), torch.from_numpy(k2), impl)
    gx, gb, *gw = torch.autograd.grad((y.float() * torch.from_numpy(w_out)).sum(),
                                      [xt, bt, *sd.values()])
    return (y.detach().float().numpy(), gx.numpy(), gb.numpy(),
            {k: v.numpy() for k, v in zip(sd, gw)})


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _close(a, b, what):
    scale = max(np.abs(b).max(), 1e-6)
    np.testing.assert_allclose(a, b, rtol=G_RTOL, atol=G_ATOL * scale, err_msg=what)


@pytest.mark.parametrize("masked", [False, True])
def test_train_block_matches_jax_f32(masked):
    """Forward y and every gradient (x, each parameter, the gathered bias)
    of the Function's plain path against the JAX kernel and jax.grad."""
    args = _setup(masked)
    yj, gxj, gbj, gwj = _jax(*args, mm="f32")
    yp, gxp, gbp, gwp = _port(*args, mm="f32")
    np.testing.assert_allclose(yp, yj, rtol=Y_RTOL, atol=Y_ATOL)
    _close(gxp, gxj, "x")
    _close(gbp, gbj, "bias")
    for k in NAMES:
        _close(gwp[k], gwj[k], k)


@pytest.mark.parametrize("masked", [False, True])
def test_train_block_matches_jax_bf16(masked):
    """bf16 activations and weights: the port rounds q with a bf16 scale
    constant after rounding qkv (the eval kernels' points), the JAX body
    rounds the float32 q once; every output and leaf still agrees to a
    cosine of 0.99999."""
    args = _setup(masked)
    x = args[0]
    yj, gxj, gbj, gwj = _jax(*args, mm="bf16")
    yp, gxp, gbp, gwp = _port(*args, mm="bf16")
    xb = torch.tensor(x).to(torch.bfloat16).float().numpy()
    readings = {"y": _cos(yp, yj), "y - x": _cos(yp - xb, yj - xb),
                "x": _cos(gxp, gxj), "bias": _cos(gbp, gbj)}
    readings.update({k: _cos(gwp[k], gwj[k]) for k in NAMES})
    low = {k: v for k, v in readings.items() if v < COS_BAR}
    assert not low, low


@pytest.mark.parametrize("shift", [0, 4])
def test_explicit_backward_is_autograd_f32(shift):
    """In float32 every rounding point is the identity, so the plain
    explicit backward must equal torch autograd of the plain forward."""
    x, p, bias, mask, k1, k2, heads, w_out = _setup(bool(shift))
    out = {}
    for impl in ("plain", "autograd"):
        sd = {k: torch.tensor(_get(p, path).T if t else _get(p, path)).requires_grad_()
              for k, (path, t) in NAMES.items()}
        bt = torch.tensor(bias).requires_grad_()
        xt = torch.tensor(x).requires_grad_()
        blk = swin.block_layout(lambda k: sd[k], heads, bt, torch.float32)
        m = None if mask is None else torch.from_numpy(mask)
        y = swin_train.fused_swin_block_train(
            xt, blk, m, shift, torch.from_numpy(k1), torch.from_numpy(k2), impl)
        out[impl] = (y.detach(), torch.autograd.grad((y * torch.from_numpy(w_out)).sum(),
                                                     [xt, bt, *sd.values()]))
    torch.testing.assert_close(out["plain"][0], out["autograd"][0], rtol=0, atol=0)
    for a, b in zip(out["plain"][1], out["autograd"][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))


def test_rel_pos_bias_gather_backward():
    """The fixed-order segment sum equals autograd of table[idx]."""
    r = np.random.default_rng(3)
    table = torch.tensor(r.standard_normal((225, 4)).astype(np.float32), requires_grad=True)
    idx_np = _relative_position_index(8, 8).reshape(-1)
    idx = torch.as_tensor(idx_np)
    g = torch.tensor(r.standard_normal((4, 64, 64)).astype(np.float32))
    got = swin_train.rel_pos_bias(table, idx, swin_train.bias_segments(idx_np))
    want = table[idx].reshape(64, 64, 4).permute(2, 0, 1)
    assert torch.equal(got, want)
    (ga,) = torch.autograd.grad((got * g).sum(), table)
    (gb,) = torch.autograd.grad((want * g).sum(), table)
    torch.testing.assert_close(ga, gb, rtol=1e-6, atol=1e-6)


def test_wgrad_and_reduce_plain_versions():
    r = np.random.default_rng(4)
    a = torch.tensor(r.standard_normal((128, 64)).astype(np.float32)).to(torch.bfloat16)
    b = torch.tensor(r.standard_normal((128, 32)).astype(np.float32)).to(torch.bfloat16)
    torch.testing.assert_close(swin_train.swin_wgrad(a, b), a.float().T @ b.float())
    parts = torch.tensor(r.standard_normal((5, 7)).astype(np.float32))
    want = parts[0] + parts[1] + parts[2] + parts[3] + parts[4]
    assert torch.equal(swin_train.swin_reduce(parts), want)


# (n, M, N): the COLA stage-0..2 weight products at B=64, the ViT CP ones
# (Audio-MAE 64 x 160 tokens, OPERA-GT 64 x 320 and 64 x 80), a ragged n
WGRAD_SHAPES = [(262144, 384, 96), (262144, 96, 384), (262144, 96, 128), (65536, 768, 192),
                (16384, 1536, 384), (16384, 384, 512), (10240, 3072, 768), (10240, 2304, 768),
                (20480, 1536, 384), (5120, 384, 1536), (64 * 77 * 3, 384, 96), (64, 32, 32)]


@pytest.mark.parametrize("n,M,N", WGRAD_SHAPES)
def test_wgrad_split_covers_the_tokens_in_fixed_chunks(n, M, N):
    """swin_wgrad's split-K plan is a function of (n, M, N) alone: its
    chunks cover [0, n) exactly, in multiples of 64 tokens, with a group
    size for the two-level ordered sum."""
    S, chunk = swin_train.wgrad_split(n, M, N)
    assert (S, chunk) == swin_train.wgrad_split(n, M, N)
    bounds = [(s * chunk, min(n, (s + 1) * chunk)) for s in range(S)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a % 64 == 0 and b % 64 == 0 and a < b for a, b in bounds)
    assert all(bounds[i][1] == bounds[i + 1][0] for i in range(S - 1))
    assert 1 <= S <= n // 64
    assert swin_train.wgrad_tile_rows(M) == (256 if M >= 512 else 128)
    group = swin_train.wgrad_group(S)
    assert group == S if S <= swin_train.WGRAD_ONE_LEVEL else (group - 1) ** 2 < S <= group ** 2


@pytest.mark.parametrize("n,M,N", [(4096, 1536, 384), (4096, 384, 1536), (4096, 384, 512),
                                   (2048, 1152, 384), (2048, 384, 384), (2624, 384, 96)])
def test_wgrad_ordered_sum_model_matches_ref(n, M, N):
    """The plain model of swin_wgrad's sum (float32 partials a chunk,
    summed in chunk order in groups, then the groups in order) agrees with
    the one-product wgrad_ref to 1e-6 of the largest entry, at the COLA
    stage-2 and ViT-S widths cut to a small n."""
    r = np.random.default_rng(n + M + N)
    a = torch.tensor(r.standard_normal((n, M)).astype(np.float32)).to(torch.bfloat16)
    b = torch.tensor(r.standard_normal((n, N)).astype(np.float32)).to(torch.bfloat16)
    S, chunk = swin_train.wgrad_split(n, M, N)
    assert S > 1  # the sum has more than one chunk
    parts = [swin_train.wgrad_ref(a[i:i + chunk], b[i:i + chunk]) for i in range(0, n, chunk)]
    group = swin_train.wgrad_group(S)
    sums = [swin_train.reduce_ref(torch.stack(parts[g:g + group])) for g in range(0, S, group)]
    got, want = swin_train.reduce_ref(torch.stack(sums)), swin_train.wgrad_ref(a, b)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-6


def test_cpu_tensors_never_reach_the_library():
    """CPU tensors run the plain versions of every train kernel: no build,
    no launch, and the Function's kernel path equals its plain path."""
    args = _setup(True)
    before = swin.launch_counts()
    yk, gxk, gbk, gwk = _port(*args, mm="bf16", impl="kernel")
    yp, gxp, gbp, gwp = _port(*args, mm="bf16", impl="plain")
    assert swin.launch_counts() == before
    assert set(before) == {"swin_attn", "swin_mlp", "swin_attn_f32", "swin_mlp_f32",
                           "swin_attn_bwd", "swin_mlp_bwd", "swin_wgrad", "swin_reduce",
                           "swin_attn_bwd_f32", "swin_mlp_bwd_f32", "swin_wgrad_f32"}
    np.testing.assert_array_equal(yk, yp)
    np.testing.assert_array_equal(gxk, gxp)
    np.testing.assert_array_equal(gbk, gbp)
    for k in NAMES:
        np.testing.assert_array_equal(gwk[k], gwp[k])
