"""The float32 mode of the ViT kernels (csrc/vit_f32.cu, csrc/vit_attn_bwd_f32.cu,
and csrc/swin_mlp_f32.cu / swin_mlp_bwd_f32.cu as the MLP half) on the CPU:

  - the training block at float32 (impl "kernel": the kernels' plain
    versions with the explicit backward on the CPU) against the JAX
    package's fused_vit_block_train (mm_dtype=float32, "emit" mode,
    interpret mode), at head dim 64 (the kernels'), with and without padded
    tokens;
  - the MAE pretraining loss and every gradient leaf of a float32 step with
    the training blocks against the JAX mae_train_loss_fused at float32
    (interpret mode);
  - the trainers' route at float32 with fused_train=True, and CPU float32
    tensors never reaching the library;
  - the launch plans at every geometry the towers launch, what they refuse,
    their constants against the CUDA sources, the entry points' ctypes
    signatures;
  - a float32 model of the attention core's softmax statistics (the key
    tiles in order, a thread's 4 columns, the 16-lane butterfly, the
    rescaled running sum) against float64.

The kernels themselves run only on a card: tests/test_torch_kernels.py."""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.models import vit_mae as jvit
from heart_murmur_detection_tpu.models.mae_train_fused import mae_train_loss_fused as jax_loss
from heart_murmur_detection_tpu.ops.pallas_vit import pad_tokens as jax_pad_tokens
from heart_murmur_detection_tpu.ops.pallas_vit_train import fused_vit_block_train as jax_block
from heart_murmur_detection_tpu_torch.extract import convert
from heart_murmur_detection_tpu_torch.models import vit_mae
from heart_murmur_detection_tpu_torch.models.mae_train_fused import mae_train_loss_fused
from heart_murmur_detection_tpu_torch.ops import _build, swin, swin_plan, swin_train, vit
from heart_murmur_detection_tpu_torch.ops import vit_plan, vit_train
from heart_murmur_detection_tpu_torch.pretrain import cola_training
from heart_murmur_detection_tpu_torch.train import finetune

from .test_torch_vit_train import G_ATOL, G_RTOL, NAMES, _get


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
C, HEADS = 128, 2  # head dim 64, the float32 kernels' own

# ---------------------------------------------------------------------------
# the training block at float32 against the JAX package
# ---------------------------------------------------------------------------


def _setup(N, seed=0):
    """A flax ViTBlock tree at C 128 / 2 heads, B=2 clips of N tokens, and
    the weights of <y[:, :N], w_out>."""
    r = np.random.default_rng(seed)
    g = lambda *s: (r.standard_normal(s) * 0.05).astype(np.float32)
    p = {
        "norm1": {"scale": 1.0 + g(C), "bias": g(C)},
        "attn_qkv": {"kernel": g(C, 3 * C) * 4, "bias": g(3 * C)},
        "attn_proj": {"kernel": g(C, C), "bias": g(C)},
        "norm2": {"scale": 1.0 + g(C), "bias": g(C)},
        "mlp_fc1": {"kernel": g(C, 4 * C), "bias": g(4 * C)},
        "mlp_fc2": {"kernel": g(4 * C, C), "bias": g(C)},
    }
    x = (r.standard_normal((2, N, C)) * 2).astype(np.float32)
    w_out = r.standard_normal((2, N, C)).astype(np.float32)
    return p, x, w_out


def _port(p, x, w_out, impl="kernel"):
    """The port's block at float32: output (real rows) and the gradients of
    <y[:, :N], w_out> with respect to x and the float32 parameters."""
    N = x.shape[1]
    leaves = {k: torch.from_numpy(np.ascontiguousarray(_get(p, path).T if t else _get(p, path)))
              .requires_grad_() for k, (path, t) in NAMES.items()}
    xp, n_real = vit.pad_tokens(torch.from_numpy(x), 16)
    xi = xp.requires_grad_()
    bp = vit.vit_block_layout(lambda k: leaves[k], HEADS, torch.float32)
    y = vit_train.fused_vit_block_train(xi, bp, n_real, impl)
    g = torch.autograd.grad((y[:, :n_real] * torch.from_numpy(w_out)).sum(),
                            [xi, *leaves.values()])
    grads = dict(zip(["x", *leaves], g))
    grads["x"] = grads["x"][:, :N]
    return y[:, :N].detach().numpy(), grads


def _jax(p, x, w_out):
    """The JAX fused block at float32 in its "emit" weight-gradient mode
    (interpret mode) and the same gradients, in the port's names."""
    N = x.shape[1]

    def f(params, xx):
        xp, nr = jax_pad_tokens(xx, 16)
        y = jax_block(xp, params, nr, num_heads=HEADS, q_chunk=64, mm_dtype=jnp.float32,
                      mode="emit", interpret=True)[:, :N]
        return jnp.sum(y * w_out), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(p, x)
    grads = {k: np.asarray(_get(gp, path)).T if t else np.asarray(_get(gp, path))
             for k, (path, t) in NAMES.items()}
    grads["x"] = np.asarray(gx)
    return np.asarray(y), grads


@pytest.mark.parametrize("N", [40, 48])  # 40 pads to 48: padded rows and masked keys
def test_f32_train_block_matches_jax_emit(N):
    """The float32 block's output, input gradient and every weight gradient
    (impl "kernel" on CPU tensors) against the JAX kernel at float32 in
    interpret mode, at test_torch_vit_train.py's bar."""
    p, x, w_out = _setup(N, seed=N)
    y, g = _port(p, x, w_out)
    jy, jg = _jax(p, x, w_out)
    np.testing.assert_allclose(y, jy, atol=G_ATOL, rtol=G_RTOL)
    for k, want in jg.items():
        np.testing.assert_allclose(g[k].numpy(), want, atol=G_ATOL, rtol=G_RTOL, err_msg=k)


# ---------------------------------------------------------------------------
# the MAE pretraining loss at float32 with the training blocks
# ---------------------------------------------------------------------------

TINY = dict(img_size=(32, 16), patch_size=4, embed_dim=C, depth=2, num_heads=HEADS,
            decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=4)


@pytest.fixture(scope="module")
def towers():
    """The JAX MAE and the port's at C 128 / 2 heads (head dim 64), on the
    same weights (the non-matrix leaves moved off their inits)."""
    jcfg, cfg = jvit.MAEConfig(**TINY), vit_mae.MAEConfig(**TINY)
    jmodel = jvit.MaskedAutoencoderViT(jcfg)
    k = jax.random.PRNGKey(0)
    v = jax.device_get(jax.jit(lambda: jmodel.init({"params": k, "masking": k},
                                                   jnp.zeros((1,) + jcfg.img_size)))())
    r = np.random.default_rng(5)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05 * r.standard_normal(a.shape).astype(
        np.float32) * (np.ndim(a) < 2 or a.shape[0] == 1), v["params"])
    model = vit_mae.MaskedAutoencoderViT(cfg, decoder=True)
    model.load_state_dict(convert.from_jax_mae({"params": params}, decoder=True))
    return jmodel, params, model


@pytest.mark.parametrize("T", [32, 8])  # 8 frames: a batch shorter than the config's image
def test_f32_fused_mae_loss_and_gradients_match_jax(towers, T):
    """The pretraining loss and every gradient leaf of a float32 step with
    fused_train=True (the training blocks, impl "kernel": their plain
    versions on the CPU) against the JAX mae_train_loss_fused at float32 in
    interpret mode, at test_torch_vit_train.py's bar."""
    jmodel, params, model = towers
    x = np.random.default_rng(T).standard_normal((2, T, 16)).astype(np.float32)
    noise = np.random.default_rng(T + 1).random((2, (T // 4) * 4)).astype(np.float32)
    model.zero_grad(set_to_none=True)
    loss = mae_train_loss_fused(model, torch.from_numpy(x), torch.from_numpy(noise), None,
                                torch.float32, "kernel")
    loss.backward()
    g = {k: q.grad for k, q in model.named_parameters()}
    f = lambda q: jax_loss(jmodel, q, x, None, mm_dtype=jnp.float32, interpret=True, noise=noise)
    jl, jgt = jax.jit(jax.value_and_grad(f))(params)
    jg = convert.from_jax_mae({"params": jax.device_get(jgt)}, decoder=True)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4, atol=1e-5)
    assert set(g) == set(jg)
    for k, want in jg.items():
        np.testing.assert_allclose(g[k].numpy(), want.numpy(), atol=G_ATOL, rtol=G_RTOL,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the route and the dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_f32_fused_train_route_is_the_kernels(device):
    """fused_train=True at float32 (compute_dtype None or float32) takes the
    kernel route in both trainers, on a card and on the CPU; without it
    float32 is torch autograd."""
    dev = torch.device(device)
    for impl in (cola_training.train_impl, finetune.train_impl):
        for dtype in (None, torch.float32):
            assert impl(dtype, True, dev) == "kernel"
            assert impl(dtype, None, dev) == "autograd"
            assert impl(dtype, False, dev) == "autograd"


def test_cpu_f32_tensors_never_reach_the_library(monkeypatch):
    """CPU float32 tensors run the plain versions of every float32 ViT
    kernel, through the dispatching wrappers, the float32 wrappers and the
    training Function: no build, no launch, no count."""
    def refuse():
        raise AssertionError("the CUDA library was loaded for CPU tensors")

    monkeypatch.setattr(swin_train, "_lib", refuse)
    monkeypatch.setattr(vit_train, "_lib", refuse)
    monkeypatch.setattr(_build, "load_library", refuse)
    p, x, w_out = _setup(40, seed=3)
    sd = {k: torch.from_numpy(np.ascontiguousarray(_get(p, path).T if t else _get(p, path)))
          for k, (path, t) in NAMES.items()}
    bp = vit.vit_block_layout(lambda k: sd[k], HEADS, torch.float32)
    xt, n_real = vit.pad_tokens(torch.from_numpy(x), 16)
    dy = torch.zeros_like(xt)
    dy[:, :n_real] = torch.from_numpy(w_out)
    before = ({**vit.launch_counts(), **vit_train.launch_counts(), **swin.launch_counts()})
    assert {"vit_qkv_f32", "vit_attn_f32", "vit_proj_f32", "vit_mlp_f32", "vit_attn_bwd_f32",
            "vit_mlp_bwd_f32", "swin_wgrad_f32"} <= set(before)
    qkv_r = vit.vit_qkv_ref(xt, bp)
    for fn in (vit.vit_qkv, vit.vit_qkv_f32):
        assert torch.equal(fn(xt, bp), qkv_r)
    o_r = vit.vit_attn_core_ref(qkv_r, bp, n_real)
    for fn in (vit.vit_attn, vit.vit_attn_f32):
        assert torch.equal(fn(qkv_r, bp, n_real), o_r)
    for fn in (vit.vit_proj, vit.vit_proj_f32):
        assert torch.equal(fn(o_r, xt, bp), vit.vit_proj_ref(o_r, xt, bp))
    h1 = vit.vit_attn_ref(xt, bp, n_real)
    for fn in (vit.vit_mlp, vit.vit_mlp_f32):
        assert torch.equal(fn(h1, bp), vit.vit_mlp_ref(h1, bp))
    for fn in (vit_train.vit_mlp_bwd, vit_train.vit_mlp_bwd_f32):
        d, g = fn(h1, dy, bp)
        dr, gr = vit_train.vit_mlp_bwd_ref(h1, dy, bp)
        assert torch.equal(d, dr) and all(torch.equal(g[q], gr[q]) for q in gr)
    for fn in (vit_train.vit_attn_bwd, vit_train.vit_attn_bwd_f32):
        d, g = fn(xt, dy, bp, n_real)
        dr, gr = vit_train.vit_attn_bwd_ref(xt, dy, bp, n_real)
        assert torch.equal(d, dr) and all(torch.equal(g[q], gr[q]) for q in gr)
    assert torch.equal(vit.fused_vit_block(xt, bp, n_real),
                       vit.fused_vit_block(xt, bp, n_real, impl="plain"))
    _port(p, x, w_out)
    assert {**vit.launch_counts(), **vit_train.launch_counts(), **swin.launch_counts()} == before


# ---------------------------------------------------------------------------
# the launch plans
# ---------------------------------------------------------------------------

# (C, heads, Np) of the towers: the masked MAE CP and fine-tuning (every patch)
TOWER_GEOMETRIES = [(384, 6, 320), (384, 6, 1040), (768, 12, 160), (768, 12, 528)]


def _covers(tiles, M, N):
    seen = np.zeros((M, N), np.int32)
    for (r0, r1), (c0, c1) in tiles:
        seen[r0:r1, c0:c1] += 1
    return bool((seen == 1).all())


def _runs_cover(bounds, total):
    """[first, last) runs covering [0, total) in order, none empty."""
    ok = bounds[0][0] == 0 and bounds[-1][1] == total
    return ok and all(a < b for a, b in bounds) and all(
        bounds[i][1] == bounds[i + 1][0] for i in range(len(bounds) - 1))


@pytest.mark.parametrize("C,heads,Np", TOWER_GEOMETRIES)
@pytest.mark.parametrize("B", [1, 4, 64])
def test_f32_vit_plans_fit_and_cover(C, heads, Np, B):
    """The forward plans at every B (B Np in 16s: the products' last row
    tile partial); the backward plans where B Np is a multiple of 64 (the
    weight products' steps), a ValueError elsewhere."""
    n = B * Np
    for g, (M, N, K) in ((vit_plan.qkv_f32_plan(n, C), (n, 3 * C, C)),
                         (vit_plan.proj_f32_plan(n, C), (n, C, C))):
        assert (g.M, g.N, g.K) == (M, N, K) and g.smem_bytes <= swin_plan.SMEM_LIMIT
        assert g.grid == (-(-n // 64), N // 96) and _covers(g.tiles(), M, N)
    mp = vit_plan.mlp_f32_plan(n, C, 4 * C)
    assert mp.workspace_shape == (n, 4 * C)
    assert _covers(mp.fc1.tiles(), n, 4 * C) and _covers(mp.fc2.tiles(), n, C)
    ap = vit_plan.attn_f32_plan(B, Np, C, heads)
    assert ap.grid == (-(-Np // 64), heads, B) and ap.smem_bytes <= swin_plan.SMEM_LIMIT
    assert _runs_cover(ap.tiles(), Np)
    if n % 64:
        with pytest.raises(ValueError):
            vit_plan.attn_bwd_f32_plan(B, Np, C, heads)
        return
    bp = vit_plan.attn_bwd_f32_plan(B, Np, C, heads)
    assert bp.attn_grid == ap.grid and _runs_cover(bp.tiles(), Np)
    assert max(bp.query_smem_bytes, bp.key_smem_bytes, bp.row_smem_bytes) <= swin_plan.SMEM_LIMIT
    assert 1 <= bp.grid <= swin_plan.F32_MLP_BWD_ROWS and bp.part_rows == bp.grid
    assert bp.part_cols == 6 * C and bp.stats_shape == (3, B * heads * Np)
    assert _runs_cover([b for _, b in bp.rp_blocks()], n)
    for g, (M, N, K) in ((bp.qkv, (n, 3 * C, C)), (bp.do, (n, C, C)), (bp.dh, (n, C, 3 * C))):
        assert (g.M, g.N, g.K) == (M, N, K) and _covers(g.tiles(), M, N)
    # the MLP backward (swin_mlp_bwd_f32.cu) at the towers' widths, and the
    # four weight products of a block
    mb = swin_plan.mlp_bwd_f32_plan(n, C, 4 * C)
    assert mb.part_cols == 7 * C and mb.row_smem_bytes <= swin_plan.SMEM_LIMIT
    assert _runs_cover([b for _, b in mb.rp_blocks()], n)
    for M, N in ((4 * C, C), (C, 4 * C), (3 * C, C), (C, C)):
        wp = swin_plan.wgrad_f32_plan(n, M, N)
        assert wp.chunks()[0][0] == 0 and wp.chunks()[-1][1] == n


def test_mlp_bwd_f32_plan_takes_the_vit_b_width():
    """swin_mlp_bwd_f32.cu's plan at C 768 (Audio-MAE), its row pass's
    shared memory past the 48 KB a launch takes without the opt-in
    attribute (72 KB), the swin blocks still held to C <= 384."""
    mp = swin_plan.mlp_bwd_f32_plan(64 * 160, 768, 3072)
    assert (mp.fc1.N, mp.fc1.K, mp.dm.N, mp.dm.K) == (3072, 768, 768, 3072)
    assert mp.row_smem_bytes == 4 * 8 * 3 * 768 > 48 * 1024
    assert mp.grid == 64 * 160 // 64 and mp.part_cols == 3072 + 3 * 768
    x = torch.zeros(1, 8, 8, 768)
    blk = swin.SwinBlockParams(32, 24, *(torch.zeros(1),) * 2, torch.zeros(3 * 32 * 32, 768),
                               torch.zeros(1), torch.zeros(768, 768), *(torch.zeros(1),) * 8)
    with pytest.raises(ValueError, match="384"):
        swin_train._check_bwd_args(x, x, torch.ones(1), blk, torch.float32)


def test_f32_vit_plans_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        vit_plan.qkv_f32_plan(1040, 1024)  # HeAR's width: no float32 route
    with pytest.raises(ValueError):
        vit_plan.mlp_f32_plan(1040, 512, 2048)  # no such width
    with pytest.raises(ValueError):
        vit_plan.proj_f32_plan(1000, 384)  # tokens not in 16s
    with pytest.raises(ValueError):
        vit_plan.attn_f32_plan(1, 320, 384, 12)  # head dim 32, not 64
    with pytest.raises(ValueError):
        vit_plan.attn_f32_plan(1, 312, 384, 6)  # Np not a multiple of 16
    with pytest.raises(ValueError):
        vit_plan.attn_f32_plan(0, 320, 384, 6)
    with pytest.raises(ValueError):
        vit_plan.attn_bwd_f32_plan(1, 1040, 384, 6)  # B Np not a multiple of 64
    with pytest.raises(ValueError):
        vit_plan.attn_bwd_f32_plan(4, 160, 1024, 16)


def _source(path):
    with open(os.path.join(CSRC, path)) as f:
        return f.read()


def _constants(src):
    return {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", src)}


def test_f32_vit_plan_constants_match_the_sources():
    """The plans' tiles, threads and shared-memory sums use the kernels'
    constants (each launch also checks them against its compiled ones)."""
    attn = _source("vit_f32_attn.cuh")
    fwd, bwd = _source("vit_f32.cu"), _source("vit_attn_bwd_f32.cu")
    ac = _constants(attn)
    assert (ac["AT"], ac["AHD"], ac["ATHREADS"]) == (vit_plan.F32_ATTN_TILE, vit_plan.HD,
                                                     vit_plan.F32_ATTN_THREADS)
    assert "RS = AT + 4" in attn and "CS = AT + 1" in attn
    assert (vit_plan.F32_ROW_STRIDE, vit_plan.F32_COL_STRIDE) == (ac["AT"] + 4, ac["AT"] + 1)
    assert "2 * (size_t)AHD * RS + 2 * (size_t)AHD * CS" in fwd
    assert "4 * (size_t)AT * RS + 2 * (size_t)AT * CS;" in bwd
    assert "4 * (size_t)AT * RS + 2 * (size_t)AT * CS + 3 * AT;" in bwd
    rs, cs, at = ac["AT"] + 4, ac["AT"] + 1, ac["AT"]
    assert vit_plan.attn_f32_plan(1, 320, 384, 6).smem_bytes == 4 * (2 * 64 * rs + 2 * 64 * cs)
    bp = vit_plan.attn_bwd_f32_plan(4, 160, 768, 12)
    assert bp.query_smem_bytes == 4 * (4 * at * rs + 2 * at * cs)
    assert bp.key_smem_bytes == 4 * (4 * at * rs + 2 * at * cs + 3 * at)
    common = _constants(_source("swin_f32_common.cuh"))
    assert (common["GBM"], common["GBN"], common["GBK"]) == (
        swin_plan.F32_TILE_ROWS, swin_plan.F32_TILE_COLS, swin_plan.F32_TILE_K)
    assert vit_plan.F32_TOKEN_TILE == swin_plan.F32_TILE_ROWS == vit_train.TOKEN_TILE


def test_f32_vit_entry_points_match_their_c_declarations():
    """The ctypes signatures of the float32 ViT entry points follow the C
    declarations argument by argument: every pointer and the stream a
    c_void_p, each int a c_int, the LayerNorm eps a c_float."""
    kind = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    for name, path in (("vit_qkv_f32_launch", "vit_f32.cu"), ("vit_attn_f32_launch", "vit_f32.cu"),
                       ("vit_proj_f32_launch", "vit_f32.cu"),
                       ("vit_attn_bwd_f32_launch", "vit_attn_bwd_f32.cu")):
        decl = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", _source(path),
                         re.S).group(1)
        kinds = [("ptr" if "*" in a else "float" if "float" in a else "int")
                 for a in decl.split(",")]
        assert kinds[-1] == "ptr" and "float" not in kinds[:-2], name
        assert _build._SIGNATURES[name] == [kind[k] for k in kinds], name


# ---------------------------------------------------------------------------
# the attention core's softmax sums
# ---------------------------------------------------------------------------


def _stats_model(s, n_real):
    """The core's row statistics of scores s (rows, Np) in float32: key
    tiles of 64 in order (those past n_real skipped, keys past n_real at
    -1e9); in a tile, thread tj's 4 columns tj + 16 b summed in b order,
    the 16 partial sums combined by the xor-8, 4, 2, 1 butterfly, the
    running max and sum rescaled by exp(m_old - m_new) as the max moves.
    Returns (m, l, P = exp(s - m) / l)."""
    rows, Np = s.shape
    s = s.clone()
    s[:, n_real:] = -1e9
    m = torch.full((rows,), float("-inf"))
    l = torch.zeros(rows)
    for j0 in range(0, n_real, 64):
        t = torch.full((rows, 64), -1e9)
        t[:, :min(64, Np - j0)] = s[:, j0:j0 + 64]
        mn = torch.maximum(m, t.max(1).values)
        c = torch.exp(m - mn)
        e = torch.exp(t - mn[:, None]).reshape(rows, 4, 16)  # [b][tj]: column tj + 16 b
        v = ((e[:, 0] + e[:, 1]) + e[:, 2]) + e[:, 3]  # (rows, 16 lanes)
        for o in (8, 4, 2, 1):
            v = v + v[:, torch.arange(16) ^ o]
        l = l * c + v[:, 0]
        m = mn
    return m, l, torch.exp(s - m[:, None]) * (1.0 / l)[:, None]


@pytest.mark.parametrize("Np,n_real", [(1040, 1025), (528, 513), (320, 308), (160, 154)])
def test_softmax_sum_order_model_matches_float64(Np, n_real):
    """The float32 model of the core's statistics against float64: the row
    max exactly, the sum of exp(s - m) within 1e-6 relative, every P within
    1e-6 and each row of P summing to 1 within 1e-6 (P's own rounding, that
    of exp at an argument s - m rounded to float32, is ~1e-6 relative where
    P is tiny), at the towers' token counts and a score spread of real ViT
    logits."""
    r = np.random.default_rng(Np)
    s = torch.from_numpy((r.standard_normal((64, Np)) * 4).astype(np.float32))
    m, l, P = _stats_model(s, n_real)
    sd = s.double()[:, :n_real]
    md = sd.max(1).values
    ld = torch.exp(sd - md[:, None]).sum(1)
    assert torch.equal(m.double(), md)
    assert float(((l.double() - ld) / ld).abs().max()) <= 1e-6
    Pd = torch.softmax(sd, 1)
    assert float((P[:, :n_real].double() - Pd).abs().max()) <= 1e-6
    assert float((P.double().sum(1) - 1).abs().max()) <= 1e-6
    assert not P[:, n_real:].any()
