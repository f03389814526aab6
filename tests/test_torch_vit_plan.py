"""The launch plans of csrc/vit_rows.cu (ops/vit_plan.py: HeAR's ViT-L qkv
and MLP halves at C 1024 as a LayerNorm row pass and persistent token-row
GEMMs) at HeAR's token counts, and the plans' float32 models of the
kernels' sum order and rounding points against the plain versions and the
JAX package's K6 / K7.

The plans are host arithmetic: each block's tiles follow the kernel's own
index arithmetic (block b of G takes tiles b, b + G, ...; tile t at column
tile t % (N / 128), row tile t // (N / 128)), so the coverage checks here
are checks of the launches. The kernels themselves run on a card only
(test_torch_kernels.py, chip_smoke.py phase 22)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.ops import pallas_vit as pv
from heart_murmur_detection_tpu_torch.ops import swin_plan, vit, vit_plan

SMS = 132  # an H100 SXM
C, HIDDEN, HEADS, NP, N_REAL = 1024, 4096, 16, 112, 97
BATCHES = (1, 16, 64)  # clips of 97 tokens padded to 112: HeAR's extraction batches
# token rows: those batches, a batch of 32 and a ragged count (3 clips of 77)
TOKENS = [B * NP for B in BATCHES] + [32 * NP, 3 * 77]
KERNEL_BAR = 0.99999  # the kernel fidelity bar (ROADMAP precision classes)
BLOCK_BF16_COS = 0.99995  # one half's bf16 branch against JAX (test_torch_hear.py's bar)


def _gemms(n):
    m, q = vit_plan.mlp_plan(n, C, HIDDEN, SMS), vit_plan.qkv_plan(n, C, SMS)
    return {"qkv": q.qkv, "fc1": m.fc1, "fc2": m.fc2}


@pytest.mark.parametrize("n", TOKENS)
def test_rows_plans_cover_each_output_once(n):
    """Every output element of the qkv, fc1 and fc2 products is in exactly
    one tile, and every tile is exactly one block's; at most one block an SM."""
    for name, g in _gemms(n).items():
        assert (g.M, g.N) == (n, {"qkv": 3 * C, "fc1": HIDDEN, "fc2": C}[name])
        assert 0 < g.grid <= min(SMS, g.tiles)
        owner = {}
        for b, tiles in g.blocks():
            for t in tiles:
                assert t not in owner, (name, t)
                owner[t] = b
        assert sorted(owner) == list(range(g.tiles))
        cover = np.zeros((g.M, g.N), np.int32)
        for t in owner:
            (r0, r1), (c0, c1) = g.tile(t)
            cover[r0:r1, c0:c1] += 1
        assert (cover == 1).all(), name


@pytest.mark.parametrize("n", TOKENS)
def test_rows_plans_run_each_product_once(n):
    """fc1 and fc2 run once a token (16 C^2 operations a token at hidden
    4 C) and qkv 6 C^2, against the 40 C^2 of the layout these kernels
    replaced at C 1024 (swin_mlp.cu's panels of 64 rows, four blocks a panel
    over 256 output columns each, each block running fc1 over all of
    hidden)."""
    assert vit_plan.mlp_plan(n, C, HIDDEN, SMS).operations == 16 * C * C * n
    assert vit_plan.qkv_plan(n, C, SMS).operations == 6 * C * C * n
    panels, out_cols = -(-n // 64), C // 4
    old_ops = panels * 4 * (2 * 64 * C * HIDDEN + 2 * 64 * HIDDEN * out_cols)
    assert old_ops == 40 * C * C * panels * 64


@pytest.mark.parametrize("n", TOKENS)
def test_rows_plans_fit_shared_memory(n):
    """Each GEMM block's ring and staged tile fit the 227 KB of shared memory
    a block can have; the launches use no cluster, so none has to divide
    the grid."""
    for g in _gemms(n).values():
        assert g.smem_bytes <= swin_plan.SMEM_LIMIT
        assert g.k_steps * vit_plan.GEMM_BK == g.K
        # one tile a block at most: both warpgroups on it; else ping-pong
        assert g.cooperative == all(len(t) <= 1 for _, t in g.blocks())


def test_rows_plans_refuse_other_widths():
    with pytest.raises(ValueError):
        vit_plan.mlp_plan(112, 768, 3072, SMS)
    with pytest.raises(ValueError):
        vit_plan.qkv_plan(112, 384, SMS)
    with pytest.raises(ValueError):
        vit_plan.mlp_plan(112, C, 4000, SMS)  # hidden not whole 128-column tiles


def test_plan_constants_match_the_source():
    """The plan's layout constants are csrc/vit_rows.cu's."""
    src = (Path(vit_plan.__file__).resolve().parent.parent / "csrc" / "vit_rows.cu").read_text()
    num = lambda name: int(re.search(rf"\b{name}\s*=\s*(\d+)", src).group(1))
    assert num("RG_STAGES") == vit_plan.STAGES
    assert num("RG_ROWS") == vit_plan.TILE_ROWS
    assert num("LN_WARPS") == vit_plan.LN_WARPS
    assert num("ROWS_WIDTH") in vit_plan.ROWS_WIDTHS
    assert "RG_STAGE_BYTES = 4 * BOX_BYTES" in src and "OUT_LD = GEMM_COLS + 8" in src
    assert vit_plan.STAGE_BYTES == 4 * 64 * 64 * 2 and vit_plan.OUT_LD == vit_plan.GEMM_COLS + 8


# ---------------------------------------------------------------------------
# the float32 models of the kernels' order
# ---------------------------------------------------------------------------


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.fixture(scope="module")
def block():
    """HeAR's block geometry on numpy weights: the JAX parameter tree, the
    port's bf16 layout, one clip of 97 real tokens padded to 112."""
    r = np.random.default_rng(1024)
    f = lambda *s: (r.standard_normal(s) * 0.03).astype(np.float32)
    p = {"norm1": {"scale": 1 + f(C), "bias": f(C)},
         "attn_qkv": {"kernel": f(C, 3 * C), "bias": f(3 * C)},
         "attn_proj": {"kernel": f(C, C), "bias": f(C)},
         "norm2": {"scale": 1 + f(C), "bias": f(C)},
         "mlp_fc1": {"kernel": f(C, HIDDEN), "bias": f(HIDDEN)},
         "mlp_fc2": {"kernel": f(HIDDEN, C), "bias": f(C)}}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    sd = {}
    for n in ("norm1", "norm2"):
        sd[f"{n}.weight"], sd[f"{n}.bias"] = t(p[n]["scale"]), t(p[n]["bias"])
    for ours, theirs in (("attn.qkv", "attn_qkv"), ("attn.proj", "attn_proj"),
                         ("mlp.fc1", "mlp_fc1"), ("mlp.fc2", "mlp_fc2")):
        sd[f"{ours}.weight"], sd[f"{ours}.bias"] = t(p[theirs]["kernel"].T), t(p[theirs]["bias"])
    x = (r.standard_normal((1, NP, C)) * 0.5).astype(np.float32)
    x[:, N_REAL:] = 0.0
    return p, vit.prep_vit_block(sd, HEADS, torch.bfloat16), x


def test_tiled_mlp_matches_vit_mlp_ref_and_jax(block):
    """The MLP half in the kernels' order (LN2 rows; fc1 tile by tile over
    64-column K steps, + b1, GELU, one rounding; fc2 likewise, + b2, + x,
    one rounding) against vit_mlp_ref, which rounds at the same points:
    branch cosine >= 0.99999 and no element more than one bf16 step of the
    largest output apart (the float32 sums run in another order); and
    against the JAX K7 (fused_vit_mlp, interpret mode) on the real rows at
    the bf16 flow's 0.99995."""
    p, pb, x = block
    xt = torch.from_numpy(x).to(torch.bfloat16)
    n = NP
    got = vit_plan.tiled_mlp(xt.reshape(n, C), pb, vit_plan.mlp_plan(n, C, HIDDEN, SMS))
    want = vit.vit_mlp_ref(xt, pb).reshape(n, C)
    base = xt.reshape(n, C).float()
    assert _cos((got.float() - base).numpy(), (want.float() - base).numpy()) >= KERNEL_BAR
    step = float(want.float().abs().max()) * 2.0 ** -7
    assert float((got.float() - want.float()).abs().max()) <= step
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    jax_out = np.asarray(pv.fused_vit_mlp(xj, p, mm_dtype=jnp.bfloat16, interpret=True),
                         np.float32)[0]
    real = slice(0, N_REAL)
    b = np.asarray(xj, np.float32)[0]
    assert _cos((got.float().numpy() - b)[real], (jax_out - b)[real]) >= BLOCK_BF16_COS


def test_tiled_qkv_matches_vit_qkv_ref(block):
    """vit_qkv in the kernels' order (the LN1 row pass, then the GEMM tile
    by tile, + b_qkv, one rounding, head-major) against vit_qkv_ref and
    ln1_rows: the LN1 rows equal, qkv at cosine >= 0.99999 and within one
    bf16 step of its largest element."""
    _, pb, x = block
    xt = torch.from_numpy(x).to(torch.bfloat16)
    qkv, h = vit_plan.tiled_qkv(xt.reshape(NP, C), pb, vit_plan.qkv_plan(NP, C, SMS), NP)
    want = vit.vit_qkv_ref(xt, pb)
    assert qkv.shape == want.shape == (3, 1, HEADS, NP, 64)
    assert torch.equal(h, vit.ln1_rows(xt, pb))
    assert _cos(qkv.float().numpy(), want.float().numpy()) >= KERNEL_BAR
    step = float(want.float().abs().max()) * 2.0 ** -7
    assert float((qkv.float() - want.float()).abs().max()) <= step


def test_mlp_argument_check_takes_both_routes(block):
    """vit_mlp's argument check passes C 1024 (csrc/vit_rows.cu's width,
    no longer csrc/swin_mlp.cu's) and refuses a width neither route has."""
    _, pb, x = block
    vit._check_cuda_args(torch.from_numpy(x).to(torch.bfloat16), pb, attn=False)
    assert C in vit_plan.ROWS_WIDTHS and C not in swin_plan.MLP_WIDTHS
    w = 512
    sd = {"norm1.weight": torch.ones(w), "norm1.bias": torch.zeros(w),
          "attn.qkv.weight": torch.zeros(3 * w, w), "attn.qkv.bias": torch.zeros(3 * w),
          "attn.proj.weight": torch.zeros(w, w), "attn.proj.bias": torch.zeros(w),
          "norm2.weight": torch.ones(w), "norm2.bias": torch.zeros(w),
          "mlp.fc1.weight": torch.zeros(4 * w, w), "mlp.fc1.bias": torch.zeros(4 * w),
          "mlp.fc2.weight": torch.zeros(w, 4 * w), "mlp.fc2.bias": torch.zeros(w)}
    with pytest.raises(ValueError, match="MLP kernels"):
        vit._check_cuda_args(torch.zeros(1, NP, w, dtype=torch.bfloat16),
                             vit.prep_vit_block(sd, 8, torch.bfloat16), attn=False)
