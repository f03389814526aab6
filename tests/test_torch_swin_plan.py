"""The launch plans of the two forward wgmma kernels (ops/swin_plan.py:
csrc/swin_mlp.cu for swin_mlp and vit_mlp, csrc/swin_attn.cu for swin_attn)
at every geometry the three towers launch, and the plain versions of those
kernels against the JAX package at the plans' edge shapes.

The plans are pure host arithmetic: each block's rows, windows, heads,
output and hidden columns follow the kernels' own index arithmetic
(blockIdx.x = (panel * out_splits + ns) * ks + rank, and group * cs + rank),
so the coverage checks here are checks of the launches. The kernels
themselves run on a card only (test_torch_kernels.py)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.models.htsat import _shift_attn_mask
from heart_murmur_detection_tpu.ops import pallas_swin as ps
from heart_murmur_detection_tpu.ops import pallas_vit as pv
from heart_murmur_detection_tpu_torch.ops import swin, swin_plan, vit, vit_plan

SMS = 132  # an H100 SXM

# operaCT: HTS-AT stages 0-3 (C, heads, H = W), 12 launches a forward
STAGES = [(96, 4, 64), (192, 8, 32), (384, 16, 16), (768, 32, 8)]
CT = [(B, C, heads, H) for B in (1, 16, 64) for C, heads, H in STAGES]
# ViT MLP rows: operaGT (16 and 64 clips of 1040 tokens), Audio-MAE (32 and
# 16 chunks of 528), the MAE CP visible-token counts of the ViT training
# tests (B = 64 of 160 at C = 768, of 320 and 80 at C = 384; B = 4 of the
# same; B = 2 of 48)
VIT = ([(B * 1040, 384) for B in (16, 64)] + [(B * 528, 768) for B in (32, 16)]
       + [(B * 160, 768) for B in (64, 4)] + [(B * Np, 384) for B in (64, 4) for Np in (320, 80)]
       + [(2 * 48, 384), (2 * 48, 768)])
# HeAR's ViT-L MLP (vit_mlp at C 1024, hidden 4096): 1, 16 and 64 clips of 97
# tokens padded to 112, which csrc/vit_rows.cu serves (ops/vit_plan.py)
HEAR = [(B * 112, 1024) for B in (1, 16, 64)]
MLP_CASES = [(B * H * H, C) for B, C, _, H in CT] + VIT


def _ids(cases):
    return ["-".join(map(str, c)) for c in cases]


@pytest.mark.parametrize("n,C", MLP_CASES, ids=_ids(MLP_CASES))
def test_mlp_plan_owns_each_output_once(n, C):
    """Every token row and output column of every panel is one block's; its
    hidden chunks split over the ks blocks of a cluster in rank order, and
    each block sums a disjoint share of the panel's rows."""
    plan = swin_plan.mlp_plan(n, C, 4 * C, SMS)
    assert plan.grid == plan.panels * plan.out_splits * plan.ks
    seen = {}
    for blk, rows, cols, hid, rank in plan.blocks():
        assert blk // plan.ks * plan.ks + rank == blk  # a cluster is ks consecutive blocks
        assert hid[0] % plan.hidden_chunk == 0 and hid[1] % plan.hidden_chunk == 0
        seen.setdefault((rows, cols), []).append((rank, hid))
    row_cover = np.zeros(n, int)
    col_cover = {}
    for (rows, cols), parts in seen.items():
        assert [r for r, _ in parts] == list(range(plan.ks))  # in rank order
        hids = [h for _, h in parts]
        assert hids[0][0] == 0 and hids[-1][1] == 4 * C
        assert all(a[1] == b[0] for a, b in zip(hids, hids[1:]))  # contiguous, rank-ordered
        col_cover.setdefault(rows, []).append(cols)
    for rows, cols in col_cover.items():
        row_cover[rows[0]:rows[1]] += 1
        assert sorted(cols) == [(i * plan.out_cols, (i + 1) * plan.out_cols)
                                for i in range(plan.out_splits)]
        assert plan.out_cols * plan.out_splits == C
    assert (row_cover == 1).all()
    eps = [plan.epilogue_rows(r) for r in range(plan.ks)]
    assert eps[0][0] == 0 and eps[-1][1] == plan.panel_rows
    assert all(a[1] == b[0] for a, b in zip(eps, eps[1:]))


@pytest.mark.parametrize("n,C", MLP_CASES, ids=_ids(MLP_CASES))
def test_mlp_plan_fits_the_card(n, C):
    """Shared memory within the block limit (the parked fc2 sums fit over
    the panel and ring they alias), the accumulators within the register
    budget, and a grid that fills the card wherever the panels can."""
    plan = swin_plan.mlp_plan(n, C, 4 * C, SMS)
    assert 2 <= plan.stages <= 8
    assert plan.smem_bytes <= swin_plan.SMEM_LIMIT
    assert plan.parked_bytes <= plan.ring_offset + plan.stages * swin_plan.MLP_STAGE
    assert plan.hidden_chunk * 128 <= swin_plan.MLP_STAGE  # a W1 box fits a stage
    assert plan.acc_floats <= swin_plan.REG_BUDGET
    assert 1 <= plan.ks <= swin_plan.MAX_CLUSTER
    if plan.panels * plan.out_splits >= SMS:
        assert plan.grid >= SMS and plan.ks == 1
    if n >= 16 * 1024:  # the serving batch and above: every stage fills >= 128 SMs
        assert plan.grid >= 128


@pytest.mark.parametrize("B,C,heads,H", CT, ids=_ids(CT))
def test_attn_plan_owns_each_head_once(B, C, heads, H):
    """Every window is one group of cs blocks (a cluster of consecutive
    blocks); their heads and proj output columns split in rank order.
    The shift only moves the addressing: the plan does not depend on it."""
    plan = swin_plan.attn_plan(B, H, H, C, heads, SMS)
    groups = {}
    for blk, wins, hs, cols, rank in plan.blocks():
        assert blk // plan.cs * plan.cs + rank == blk
        groups.setdefault(wins, []).append((rank, hs, cols))
    win_cover = np.zeros(plan.windows, int)
    for wins, parts in groups.items():
        assert 1 <= len(wins) <= plan.windows_per_block
        win_cover[list(wins)] += 1
        assert [r for r, _, _ in parts] == list(range(plan.cs))
        assert [h for _, hs, _ in parts for h in hs] == list(range(heads))
        assert [c for _, _, cols in parts for c in range(*cols)] == list(range(C))
    assert (win_cover == 1).all()


@pytest.mark.parametrize("B,C,heads,H", CT, ids=_ids(CT))
def test_attn_plan_fits_the_card(B, C, heads, H):
    plan = swin_plan.attn_plan(B, H, H, C, heads, SMS)
    assert 2 <= plan.stages <= 8
    assert plan.smem_bytes <= swin_plan.SMEM_LIMIT
    assert plan.acc_floats <= swin_plan.REG_BUDGET
    hpb, cb = heads // plan.cs, C // plan.cs
    assert cb % plan.proj_rows == 0  # whole proj passes
    assert (C // heads) * hpb % 8 == 0  # a block's head columns in 16-byte chunks
    assert plan.windows_per_block == (2 if C <= 192 else 1)
    if plan.windows_per_block == 1:
        assert hpb % 2 == 0  # the two warpgroups take two heads at a time
    else:
        assert plan.cs == 1
    assert plan.proj_rows * 128 <= plan.stage_bytes  # a proj stage fits a ring slot
    if -(-plan.windows // plan.windows_per_block) >= SMS:
        assert plan.grid >= SMS and plan.cs == 1
    if B >= 16:
        assert plan.grid >= 128


def test_plans_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        swin_plan.mlp_plan(64, 128, 512, SMS)  # width
    with pytest.raises(ValueError):
        swin_plan.mlp_plan(64, 384, 1600, SMS)  # hidden not whole chunks
    with pytest.raises(ValueError):
        swin_plan.attn_plan(1, 12, 8, 96, 4, SMS)  # H not whole windows
    with pytest.raises(ValueError):
        swin_plan.attn_plan(1, 8, 8, 96, 5, SMS)  # heads do not divide C
    with pytest.raises(ValueError):
        swin_plan.attn_plan(1, 8, 8, 384, 6, SMS)  # head dim 64


@pytest.mark.parametrize("n", [n for n, _ in HEAR])
def test_mlp_plan_at_vit_l(n):
    """C = 1024 (HeAR's ViT-L) is not csrc/swin_mlp.cu's: its plan refuses
    the width, which ops/vit_plan.py's row-pass-and-GEMM plan (the launch
    ops/vit.py takes there) serves with fc1 once a token; the swin attention
    (and its backward) still refuse C 1024."""
    with pytest.raises(ValueError):
        swin_plan.mlp_plan(n, 1024, 4096, SMS)
    assert vit_plan.mlp_plan(n, 1024, 4096, SMS).operations == 16 * 1024 * 1024 * n
    with pytest.raises(ValueError):
        swin_plan.attn_plan(1, 8, 8, 1024, 32, SMS)
    with pytest.raises(ValueError):
        swin_plan.mlp_bwd_plan(64 * 112, 1024, 4096, SMS)  # n a multiple of 64


def test_plan_constants_match_the_sources():
    """The plan's layout constants are the kernels' own."""
    csrc = Path(swin_plan.__file__).resolve().parent.parent / "csrc"
    mlp = (csrc / "swin_mlp.cu").read_text()
    attn = (csrc / "swin_attn.cu").read_text()
    common = (csrc / "swin_common.cuh").read_text()
    num = lambda src, name: int(re.search(rf"\b{name}\s*=\s*(\d+)", src).group(1))
    assert num(mlp, "MLP_STAGE") == swin_plan.MLP_STAGE
    assert num(mlp, "W2_ROWS") == swin_plan.W2_ROWS
    assert num(mlp, "PART_PAD") == swin_plan.PART_PAD
    assert "HN = C == 192 ? 64 : 128" in mlp  # the hidden chunk
    # each width's block columns (MlpCfg's NB) and the widths of the launch
    assert "NB = C <= 384 ? C : 384;" in mlp
    cases = sorted(int(c) for c in re.findall(r"HMDT_MLP_CASE\((\d+)\)", mlp))
    assert tuple(cases) == swin_plan.MLP_WIDTHS
    for C, nb in swin_plan.MLP_LAYOUT.items():
        assert nb == (C if C <= 384 else 384), C
        assert nb % swin_plan.W2_ROWS == 0 and C % nb == 0, C
    assert num(common, "HDP") == swin_plan.HDP
    assert num(common, "SMEM_LIMIT") == swin_plan.SMEM_LIMIT
    assert "NTOK * 128 + HDP * 128" in attn  # HEADBUF: k (64 keys) and v^T (32 dims)


# ---------------------------------------------------------------------------
# the plain versions against the JAX package at the new edge shapes
# ---------------------------------------------------------------------------

ATOL, RTOL = 1e-4, 1e-4  # float32, both sides
BF16_COS = 0.99995  # the bf16 flow's class (ROADMAP precision classes)


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _vit_block(C, seed):
    r = np.random.default_rng(seed)
    f = lambda *s: (r.standard_normal(s) * 0.05).astype(np.float32)
    p = {"norm1": {"scale": 1 + f(C), "bias": f(C)},
         "attn_qkv": {"kernel": f(C, 3 * C), "bias": f(3 * C)},
         "attn_proj": {"kernel": f(C, C), "bias": f(C)},
         "norm2": {"scale": 1 + f(C), "bias": f(C)},
         "mlp_fc1": {"kernel": f(C, 4 * C), "bias": f(4 * C)},
         "mlp_fc2": {"kernel": f(4 * C, C), "bias": f(C)}}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    sd = {}
    for n in ("norm1", "norm2"):
        sd[f"{n}.weight"], sd[f"{n}.bias"] = t(p[n]["scale"]), t(p[n]["bias"])
    for ours, theirs in (("attn.qkv", "attn_qkv"), ("attn.proj", "attn_proj"),
                         ("mlp.fc1", "mlp_fc1"), ("mlp.fc2", "mlp_fc2")):
        sd[f"{ours}.weight"], sd[f"{ours}.bias"] = t(p[theirs]["kernel"].T), t(p[theirs]["bias"])
    return p, sd


@pytest.mark.parametrize("B,Np", [(3, 80), (1, 176)])  # 240 and 176 tokens: not a multiple of 128
@pytest.mark.parametrize("bf16", [False, True])
def test_vit_mlp_ref_matches_jax_at_ragged_tokens(B, Np, bf16):
    """vit_mlp_ref (the plain version of vit_mlp) against the JAX K7 entry
    point in interpret mode, at token counts the kernel's panels do not
    divide: float32 at 1e-4, the bf16 flow on the branch at 0.99995."""
    C = 96
    p, sd = _vit_block(C, seed=B + Np)
    x = (np.random.default_rng(Np).standard_normal((B, Np, C))).astype(np.float32)
    mm, jmm = (torch.bfloat16, jnp.bfloat16) if bf16 else (torch.float32, jnp.float32)
    xj = jnp.asarray(x).astype(jmm)
    want = np.asarray(pv.fused_vit_mlp(xj, p, mm_dtype=jmm, interpret=True), np.float32)
    pb = vit.prep_vit_block(sd, 1, mm)
    got = vit.vit_mlp_ref(torch.from_numpy(x).to(mm), pb).float().numpy()
    if bf16:
        base = np.asarray(xj, np.float32)
        assert _cos(got - base, want - base) >= BF16_COS
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _swin_block(C, heads, seed):
    from heart_murmur_detection_tpu.models.htsat import _relative_position_index

    r = np.random.default_rng(seed)
    f = lambda *s: (r.standard_normal(s) * 0.05).astype(np.float32)
    p = {"norm1": {"scale": 1 + f(C), "bias": f(C)},
         "attn": {"qkv": {"kernel": f(C, 3 * C), "bias": f(3 * C)},
                  "proj": {"kernel": f(C, C), "bias": f(C)},
                  "relative_position_bias_table": f(15 * 15, heads) * 10},
         "norm2": {"scale": 1 + f(C), "bias": f(C)},
         "mlp": {"fc1": {"kernel": f(C, 4 * C), "bias": f(4 * C)},
                 "fc2": {"kernel": f(4 * C, C), "bias": f(C)}}}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    sd = {"norm1.weight": t(p["norm1"]["scale"]), "norm1.bias": t(p["norm1"]["bias"]),
          "norm2.weight": t(p["norm2"]["scale"]), "norm2.bias": t(p["norm2"]["bias"])}
    for ours, sub in (("attn.qkv", p["attn"]["qkv"]), ("attn.proj", p["attn"]["proj"]),
                      ("mlp.fc1", p["mlp"]["fc1"]), ("mlp.fc2", p["mlp"]["fc2"])):
        sd[f"{ours}.weight"], sd[f"{ours}.bias"] = t(sub["kernel"].T), t(sub["bias"])
    table = p["attn"]["relative_position_bias_table"]
    bias = table[_relative_position_index(8, 8).reshape(-1)].reshape(64, 64, heads)
    return p, sd, np.ascontiguousarray(bias.transpose(2, 0, 1))


# one clip: a single window at C = 96 (the odd window group of a two-window
# block), and a shifted 16 x 16 map (four windows)
SWIN_B1 = [(96, 4, 8, 0, False), (96, 4, 16, 4, False), (96, 4, 16, 4, True)]


@pytest.mark.parametrize("C,heads,H,shift,fast", SWIN_B1)
@pytest.mark.parametrize("bf16", [False, True])
def test_swin_halves_ref_match_jax_at_one_clip(C, heads, H, shift, fast, bf16):
    """swin_mlp_ref(swin_attn_ref(x)) against the JAX K1 entry point
    (fused_swin_block, interpret mode) at B = 1: float32 at 1e-4, the bf16
    flow on the block's branch at 0.99995."""
    p, sd, bias = _swin_block(C, heads, seed=H + shift)
    x = (np.random.default_rng(H).standard_normal((1, H, H, C)) * 0.5).astype(np.float32)
    mask = _shift_attn_mask(H, H, 8, shift) if shift else None
    mm, jmm = (torch.bfloat16, jnp.bfloat16) if bf16 else (torch.float32, jnp.float32)
    xj = jnp.asarray(x).astype(jmm)
    xs = jnp.roll(xj, -shift, axis=1) if shift else xj
    want = ps.fused_swin_block(xs, p, jnp.asarray(bias), None if mask is None else jnp.asarray(mask),
                               num_heads=heads, interpret=True, roll_w=shift, mm_dtype=jmm,
                               fast_softmax=fast)
    want = np.asarray(jnp.roll(want, shift, axis=1) if shift else want, np.float32)
    pb = swin.prep_block(sd, heads, torch.from_numpy(bias), mm)
    xt = torch.from_numpy(x).to(mm)
    mt = None if mask is None else torch.from_numpy(mask)
    got = swin.swin_mlp_ref(swin.swin_attn_ref(xt, pb, mt, shift, fast), pb).float().numpy()
    if bf16:
        base = np.asarray(xj, np.float32)
        assert _cos(got - base, want - base) >= BF16_COS
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
