"""The float32 mode of the swin training kernels (csrc/swin_mlp_bwd_f32.cu,
csrc/swin_attn_bwd_f32.cu, csrc/swin_wgrad_f32.cu) on the CPU:

  - the training Function at float32 (impl "kernel": the kernels' plain
    versions on the CPU) against the JAX package's fused_swin_block_train
    (mm_dtype=float32, interpret mode) and jax.grad, at the geometry the
    kernels take (head dim 24: C 96 with 4 heads, C 192 with 8; a 16 x 16
    map, B=2, shift 0 and 4 with its mask, DropPath multipliers with a 0 and
    a 1/0.9), and the gradient rows of the padded head dims exactly 0;
  - the launch plans: shared memory, every token, window, output tile and
    token chunk covered once, what they refuse, their constants against the
    CUDA sources;
  - a float32 model of swin_wgrad_f32's sum (16-token steps a chunk, the
    chunks in order) against the product in float64;
  - the dispatch: CPU float32 tensors never reach the library, the
    input-gradient-only path, and the entry points' ctypes signatures.

The kernels themselves run only on a card: tests/test_torch_kernels.py."""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.models.htsat import _shift_attn_mask
from heart_murmur_detection_tpu.ops.pallas_swin_train import fused_swin_block_train as jax_block
from heart_murmur_detection_tpu_torch.ops import _build, swin, swin_plan, swin_train

from .test_torch_swin_train import G_ATOL, G_RTOL, NAMES, Y_ATOL, Y_RTOL, _get


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the test run shares the cores among its xdist
    workers (see test_torch_swin.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "heart_murmur_detection_tpu_torch", "csrc")
F32_NAMES = ("swin_attn_bwd_f32", "swin_mlp_bwd_f32", "swin_wgrad_f32")

# ---------------------------------------------------------------------------
# the training Function at float32 against the JAX package
# ---------------------------------------------------------------------------


def _setup(C, heads, shift, seed=0):
    """B=2 on a 16 x 16 map, head dim 24, the block's flax parameters at
    0.05 scale, a gathered bias, the stage's mask where it shifts, and
    DropPath multipliers with a 0 and a 1/0.9 among them."""
    B, H = 2, 16
    r = np.random.default_rng(seed)
    x = (r.standard_normal((B, H, H, C)) * 0.5).astype(np.float32)
    g = lambda *s: (r.standard_normal(s) * 0.05).astype(np.float32)
    p = {
        "norm1": {"scale": 1.0 + g(C), "bias": g(C)},
        "attn": {"qkv": {"kernel": g(C, 3 * C), "bias": g(3 * C)},
                 "proj": {"kernel": g(C, C), "bias": g(C)}},
        "norm2": {"scale": 1.0 + g(C), "bias": g(C)},
        "mlp": {"fc1": {"kernel": g(C, 4 * C), "bias": g(4 * C)},
                "fc2": {"kernel": g(4 * C, C), "bias": g(C)}},
    }
    bias = (r.standard_normal((heads, 64, 64)) * 0.5).astype(np.float32)
    mask = _shift_attn_mask(H, H, 8, shift) if shift else None
    k1 = np.asarray([0.0, 1.0 / 0.9], np.float32)
    k2 = np.asarray([1.0 / 0.9, 1.0], np.float32)
    w_out = r.standard_normal(x.shape).astype(np.float32)
    return x, p, bias, mask, k1, k2, w_out


def _jax(x, p, bias, mask, k1, k2, w_out, heads, shift):
    """The JAX block (the caller rolls a shifted block's input and output,
    as the JAX HTS-AT does) and the gradients of <y, w_out>."""
    m = None if mask is None else jnp.asarray(mask)

    def fwd(x, p, bias):
        xr = jnp.roll(x, (-shift, -shift), (1, 2)) if shift else x
        y = jax_block(xr, p, bias, m, jnp.asarray(k1)[:, None], jnp.asarray(k2)[:, None],
                      window=8, num_heads=heads, interpret=True, mm_dtype=jnp.float32)
        return jnp.roll(y, (shift, shift), (1, 2)) if shift else y

    def loss(x, p, bias):
        return jnp.vdot(fwd(x, p, bias), jnp.asarray(w_out))

    y = jax.jit(fwd)(x, p, bias)
    gx, gp, gb = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(x, p, bias)
    grads = {k: _get(gp, path).T if t else _get(gp, path) for k, (path, t) in NAMES.items()}
    return np.asarray(y), np.asarray(gx), np.asarray(gb), grads


def _port(x, p, bias, mask, k1, k2, w_out, heads, shift, need_weights=True):
    """The port's Function at float32 (impl "kernel"), its output and the
    gradients of <y, w_out>; with need_weights False only x takes one."""
    sd = {k: torch.tensor(_get(p, path).T if t else _get(p, path)).requires_grad_(need_weights)
          for k, (path, t) in NAMES.items()}
    bt = torch.tensor(bias).requires_grad_(need_weights)
    xt = torch.tensor(x).requires_grad_()
    blk = swin.block_layout(lambda k: sd[k], heads, bt, torch.float32)
    m = None if mask is None else torch.from_numpy(mask)
    y = swin_train.fused_swin_block_train(xt, blk, m, shift, torch.from_numpy(k1),
                                          torch.from_numpy(k2), "kernel")
    leaves = [xt, bt, *sd.values()] if need_weights else [xt]
    gx, *rest = torch.autograd.grad((y * torch.from_numpy(w_out)).sum(), leaves)
    if not need_weights:
        return y.detach().numpy(), gx.numpy()
    gb, *gw = rest
    return (y.detach().numpy(), gx.numpy(), gb.numpy(),
            {k: v.numpy() for k, v in zip(sd, gw)})


def _close(a, b, what):
    """Within test_torch_swin_train.py's float32 gradient bounds, relative
    to the leaf's scale (its largest entry)."""
    scale = max(np.abs(b).max(), 1e-6)
    np.testing.assert_allclose(a, b, rtol=G_RTOL, atol=G_ATOL * scale, err_msg=what)


@pytest.mark.parametrize("C,heads", [(96, 4), (192, 8)])
@pytest.mark.parametrize("shift", [0, 4])
def test_f32_train_block_matches_jax(C, heads, shift):
    """The float32 Function's output, input gradient, gathered-bias gradient
    and every weight gradient against the JAX kernel in interpret mode and
    jax.grad; the input gradient alone (frozen weights, the saliency
    route) equal to the full backward's."""
    args = _setup(C, heads, shift)
    yj, gxj, gbj, gwj = _jax(*args, heads, shift)
    yp, gxp, gbp, gwp = _port(*args, heads, shift)
    np.testing.assert_allclose(yp, yj, rtol=Y_RTOL, atol=Y_ATOL)
    _close(gxp, gxj, "x")
    _close(gbp, gbj, "bias")
    for k in NAMES:
        _close(gwp[k], gwj[k], k)
    y_only, gx_only = _port(*args, heads, shift, need_weights=False)
    np.testing.assert_array_equal(y_only, yp)
    np.testing.assert_array_equal(gx_only, gxp)


@pytest.mark.parametrize("shift", [0, 4])
def test_f32_padded_qkv_gradient_rows_are_zero(shift):
    """The gradient rows of w_qkv and b_qkv at the padded head dims (24..31
    of each head's q, k, v) are exactly 0 in the kernels' padded layout, as
    in the JAX float32 layout (_prep_weights with hdp)."""
    C, heads = 96, 4
    x, p, bias, mask, k1, k2, w_out = _setup(C, heads, shift, seed=1)
    sd = {k: torch.tensor(_get(p, path).T if t else _get(p, path)) for k, (path, t) in NAMES.items()}
    blk = swin.block_layout(lambda k: sd[k], heads, torch.tensor(bias), torch.float32)
    m = None if mask is None else torch.from_numpy(mask)
    xt = torch.tensor(x)
    dx, g = swin_train.swin_attn_bwd_f32(xt, torch.tensor(w_out), torch.from_numpy(k1), blk, m,
                                         shift)
    assert g["w_qkv"].shape == (3 * heads * 32, C) and g["b_qkv"].shape == (3 * heads * 32,)
    pad_w = g["w_qkv"].reshape(3, heads, 32, C)[:, :, 24:]
    pad_b = g["b_qkv"].reshape(3, heads, 32)[:, :, 24:]
    assert torch.equal(pad_w, torch.zeros_like(pad_w))
    assert torch.equal(pad_b, torch.zeros_like(pad_b))
    assert float(g["w_qkv"].reshape(3, heads, 32, C)[:, :, :24].abs().max()) > 0


# ---------------------------------------------------------------------------
# the launch plans
# ---------------------------------------------------------------------------

TRAIN_GEOMETRIES = [(96, 4, 64), (192, 8, 32), (384, 16, 16)]  # (C, heads, map side)


def _covers(tiles, M, N):
    """Each (row, column) of an M x N output is in exactly one tile."""
    seen = np.zeros((M, N), np.int32)
    for (r0, r1), (c0, c1) in tiles:
        seen[r0:r1, c0:c1] += 1
    return bool((seen == 1).all())


def _contiguous(runs, total, nonempty):
    """The runs cover [0, total) in order, one after another."""
    bounds = [b for _, b in runs]
    ok = bounds[0][0] == 0 and bounds[-1][1] == total
    ok = ok and all(bounds[i][1] == bounds[i + 1][0] for i in range(len(bounds) - 1))
    return ok and all(a < b if nonempty else a <= b for a, b in bounds)


@pytest.mark.parametrize("C,heads,H", TRAIN_GEOMETRIES)
@pytest.mark.parametrize("B", [1, 4, 64, 72])
def test_f32_bwd_plans_fit_and_cover(C, heads, H, B):
    n = B * H * H
    mp = swin_plan.mlp_bwd_f32_plan(n, C, 4 * C)
    for g, (M, N, K) in ((mp.fc1, (n, 4 * C, C)), (mp.dg, (n, 4 * C, C)), (mp.dm, (n, C, 4 * C))):
        assert (g.M, g.N, g.K) == (M, N, K)
        assert g.smem_bytes <= swin_plan.SMEM_LIMIT
        assert _covers(g.tiles(), M, N)
    assert mp.row_smem_bytes <= swin_plan.SMEM_LIMIT
    assert 1 <= mp.grid <= swin_plan.F32_MLP_BWD_ROWS and mp.part_rows == mp.grid
    assert mp.part_cols == 4 * C + 3 * C
    assert _contiguous(mp.rp_blocks(), n, nonempty=True)

    ap = swin_plan.attn_bwd_f32_plan(B, H, H, C, heads)
    windows = B * (H // 8) ** 2
    assert ap.windows == windows and ap.n_tokens == n
    assert ap.core_smem_bytes <= swin_plan.SMEM_LIMIT
    # a core block a (window run, head): every window of every head once,
    # no run empty; the row pass a block for each partial row
    assert ap.core_grid == (ap.grid, heads) and 1 <= ap.grid <= windows
    assert ap.grid * heads <= swin_plan.F32_ATTN_BWD_BLOCKS + heads
    assert _contiguous(ap.blocks(), windows, nonempty=True)
    assert _contiguous(ap.rp_blocks(), n, nonempty=True)
    assert ap.part_rows == ap.grid and ap.part_cols == heads * 4096 + 3 * heads * 32 + 3 * C
    Cp3 = 3 * heads * 32
    for g, (M, N, K) in ((ap.qkv, (n, Cp3, C)), (ap.do, (n, C, C)), (ap.dh, (n, C, Cp3))):
        assert (g.M, g.N, g.K) == (M, N, K)
        assert _covers(g.tiles(), M, N)
    assert ap.row_smem_bytes <= swin_plan.SMEM_LIMIT

    # the four weight products of a block: chunks in 64s covering [0, n),
    # about F32_WGRAD_BLOCKS blocks, every output tile once
    for M, N in ((4 * C, C), (C, 4 * C), (Cp3, C), (C, C)):
        wp = swin_plan.wgrad_f32_plan(n, M, N)
        chunks = wp.chunks()
        assert chunks[0][0] == 0 and chunks[-1][1] == n and len(chunks) == wp.S
        assert all(a % 64 == 0 and a < b for a, b in chunks)
        assert all(chunks[i][1] == chunks[i + 1][0] for i in range(wp.S - 1))
        assert wp.S == 1 or wp.S * wp.tiles <= swin_plan.F32_WGRAD_BLOCKS
        assert wp.ws_floats == (wp.S * M * N if wp.S > 1 else 0)
        T = swin_plan.F32_WGRAD_TILE
        tiles = [((r, r + T), (c, c + T)) for r in range(0, M, T) for c in range(0, N, T)]
        assert len(tiles) == wp.tiles and _covers(tiles, M, N)
        assert wp == swin_plan.wgrad_f32_plan(n, M, N)  # the shapes alone fix it


def test_f32_bwd_plans_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        swin_plan.attn_bwd_f32_plan(1, 8, 8, 768, 32)  # stage 3 trains as a plain block
    with pytest.raises(ValueError):
        swin_plan.attn_bwd_f32_plan(1, 16, 16, 96, 3)  # head dim 32, not 24
    with pytest.raises(ValueError):
        swin_plan.attn_bwd_f32_plan(1, 12, 16, 96, 4)  # not whole windows
    with pytest.raises(ValueError):
        swin_plan.mlp_bwd_f32_plan(100, 96, 384)  # rows not in 64s
    with pytest.raises(ValueError):
        swin_plan.mlp_bwd_f32_plan(128, 128, 512)  # no such width
    with pytest.raises(ValueError):  # stage 3 trains as a plain block (the MLP backward's plan
        # takes C 768 for the ViT-B blocks: the swin wrappers refuse it)
        x = torch.zeros(1, 8, 8, 768)
        blk = swin.SwinBlockParams(32, 24, *(torch.zeros(1),) * 2, torch.zeros(3 * 32 * 32, 768),
                                   torch.zeros(1), torch.zeros(768, 768), *(torch.zeros(1),) * 8)
        swin_train._check_bwd_args(x, x, torch.ones(1), blk, torch.float32)
    with pytest.raises(ValueError):
        swin_plan.mlp_bwd_f32_plan(128, 96, 100)  # hidden not in 96s
    with pytest.raises(ValueError):
        swin_plan.wgrad_f32_plan(100, 96, 96)  # tokens not in 64s
    with pytest.raises(ValueError):
        swin_plan.wgrad_f32_plan(128, 96, 128)  # a width not in 96s


def _source(path):
    with open(os.path.join(CSRC, path)) as f:
        return f.read()


def _constants(src):
    return {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", src)}


def test_f32_bwd_plan_constants_match_the_sources():
    """The plans' threads, tiles and shared-memory sums use the kernels'
    constants (each launch also checks them against its compiled ones)."""
    common = _source("swin_f32_common.cuh")
    attn, wgrad = _source("swin_attn_bwd_f32.cu"), _source("swin_wgrad_f32.cu")
    cc, ac, wc = _constants(common), _constants(attn), _constants(wgrad)
    assert cc["RTHREADS"] == swin_plan.F32_ROW_THREADS
    assert "RWARPS = RTHREADS / 32" in common
    assert "sizeof(float) * RWARPS * 3 * (size_t)C" in common
    assert swin_plan.ln_bwd_smem_bytes(384) == 4 * (cc["RTHREADS"] // 32) * 3 * 384
    assert (ac["BHD"], ac["BTHREADS"]) == (swin_plan.F32_HD, swin_plan.F32_BWD_THREADS)
    # the core's sum as the source forms it (NTOK = 64 tokens a window)
    assert "TS = NTOK + 4" in attn and "PS = NTOK + 1" in attn and "OS = 3 * BHD + 1" in attn
    assert ("2 * (size_t)BHD * TS + 2 * (size_t)BHD * NTOK + 4 * (size_t)NTOK * BHD +\n"
            "         2 * (size_t)NTOK * PS + (size_t)NTOK * OS") in attn
    hd, ts, ps, os_ = ac["BHD"], 64 + 4, 64 + 1, 3 * ac["BHD"] + 1
    core = 4 * (2 * hd * ts + 2 * hd * 64 + 4 * 64 * hd + 2 * 64 * ps + 64 * os_)
    assert swin_plan.attn_bwd_f32_plan(1, 8, 8, 96, 4).core_smem_bytes == core
    assert (wc["WT"], wc["WK"], wc["WTHREADS"]) == (
        swin_plan.F32_WGRAD_TILE, swin_plan.F32_WGRAD_K, swin_plan.F32_WGRAD_THREADS)
    assert wc["WTHREADS"] == (wc["WT"] // wc["WTM"]) * (wc["WT"] // wc["WTN"])


# ---------------------------------------------------------------------------
# swin_wgrad_f32's order of summation
# ---------------------------------------------------------------------------


def _wgrad_f32_model(a, b):
    """swin_wgrad_f32's sum in float32: each chunk's partial as 16-token
    steps, each step's product added to the chunk's running sum; the
    chunks' partials summed in chunk order (swin_reduce)."""
    n, M = a.shape
    plan = swin_plan.wgrad_f32_plan(n, M, b.shape[1])
    parts = []
    for t0, t1 in plan.chunks():
        acc = torch.zeros(M, b.shape[1])
        for k in range(t0, t1, swin_plan.F32_WGRAD_K):
            acc += a[k:k + swin_plan.F32_WGRAD_K].T @ b[k:k + swin_plan.F32_WGRAD_K]
        parts.append(acc)
    return swin_train.reduce_ref(torch.stack(parts)), plan.S


@pytest.mark.parametrize("n,M,N", [(4096, 384, 96), (4096, 96, 384), (2048, 1536, 384),
                                   (2048, 384, 1536), (8192, 96, 96), (64, 96, 96)])
def test_wgrad_f32_ordered_sum_model_matches_float64(n, M, N):
    """The float32 model of swin_wgrad_f32's sum against the product in
    float64: within 2e-6 of the largest entry (float32 rounding over n / 16
    steps and S chunks), at the COLA stage-0 and stage-2 widths cut to a
    small n."""
    r = np.random.default_rng(n + M + N)
    a = torch.tensor(r.standard_normal((n, M)).astype(np.float32))
    b = torch.tensor(r.standard_normal((n, N)).astype(np.float32))
    got, S = _wgrad_f32_model(a, b)
    assert S > 1 or n == 64
    want = a.double().T @ b.double()
    assert float((got.double() - want).abs().max() / want.abs().max()) <= 2e-6
    assert float((swin_train.wgrad_ref(a, b).double() - want).abs().max() / want.abs().max()) <= 2e-6


# ---------------------------------------------------------------------------
# the dispatch on the CPU and the ctypes signatures
# ---------------------------------------------------------------------------


def test_cpu_f32_tensors_never_reach_the_library(monkeypatch):
    """CPU float32 tensors run the plain versions of every float32 train
    kernel, through the dispatching wrappers and the Function: no build, no
    launch."""
    def refuse():
        raise AssertionError("the CUDA library was loaded for CPU tensors")

    monkeypatch.setattr(swin_train, "_lib", refuse)
    monkeypatch.setattr(_build, "load_library", refuse)
    C, heads, shift = 96, 4, 4
    x, p, bias, mask, k1, k2, w_out = _setup(C, heads, shift, seed=2)
    sd = {k: torch.tensor(_get(p, path).T if t else _get(p, path)) for k, (path, t) in NAMES.items()}
    blk = swin.block_layout(lambda k: sd[k], heads, torch.tensor(bias), torch.float32)
    m, xt, dy = torch.from_numpy(mask), torch.tensor(x), torch.tensor(w_out)
    kt = torch.from_numpy(k1)
    before = swin.launch_counts()
    assert set(F32_NAMES) <= set(before)
    h1 = swin.swin_attn(xt, blk, m, shift, kmul=kt)
    for fn in (swin_train.swin_mlp_bwd, swin_train.swin_mlp_bwd_f32):
        d, g = fn(h1, dy, kt, blk)
        dr, gr = swin_train.swin_mlp_bwd_ref(h1, dy, kt, blk)
        assert torch.equal(d, dr) and all(torch.equal(g[q], gr[q]) for q in gr)
    for fn in (swin_train.swin_attn_bwd, swin_train.swin_attn_bwd_f32):
        d, g = fn(xt, dy, kt, blk, m, shift)
        dr, gr = swin_train.swin_attn_bwd_ref(xt, dy, kt, blk, m, shift)
        assert torch.equal(d, dr) and all(torch.equal(g[q], gr[q]) for q in gr)
    a2, b2 = xt.reshape(-1, C), dy.reshape(-1, C)
    for fn in (swin_train.swin_wgrad, swin_train.swin_wgrad_f32):
        assert torch.equal(fn(a2, b2), swin_train.wgrad_ref(a2, b2))
    _port(x, p, bias, mask, k1, k2, w_out, heads, shift)
    assert swin.launch_counts() == before


def test_f32_bwd_entry_points_match_their_c_declarations():
    """The ctypes signatures of the float32 backward entry points follow
    the C declarations in the sources argument by argument: every pointer
    and the stream a c_void_p (a c_int would cut a 64-bit pointer), each
    int a c_int, swin_mlp_bwd_f32's LayerNorm eps a c_float."""
    kind = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    for name in ("swin_mlp_bwd_f32_launch", "swin_attn_bwd_f32_launch", "swin_wgrad_f32_launch"):
        src = _source(name[:-len("_launch")] + ".cu")
        decl = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src, re.S).group(1)
        kinds = [("ptr" if "*" in a else "float" if "float" in a else "int")
                 for a in decl.split(",")]
        assert kinds[-1] == "ptr" and "float" not in kinds[:-2], name
        assert _build._SIGNATURES[name] == [kind[k] for k in kinds], name
