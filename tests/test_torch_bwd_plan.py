"""The launch plans of the two backward wgmma kernels (ops/swin_plan.py:
csrc/swin_mlp_bwd.cu for swin_mlp_bwd and vit_mlp_bwd, csrc/swin_attn_bwd.cu
for swin_attn_bwd) at every geometry the towers launch, and float32 models
of the orders in which the kernels sum their columns.

The plans are pure host arithmetic: each block's units, windows and row-pass
tiles follow the kernels' own index arithmetic (block b of G walks [b U / G,
(b + 1) U / G) of U units; row-pass block b the 16-token tiles [b tpb, (b +
1) tpb)), so the coverage checks here are checks of the launches. The
kernels themselves run on a card only (test_torch_kernels.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu_torch.ops import swin_plan

SMS = 132  # an H100 SXM

# COLA and operaCT fine-tuning: HTS-AT stages 0-2 (C, heads, H = W) at the
# batches the steps and the tests launch
STAGES = [(96, 4, 64), (192, 8, 32), (384, 16, 16)]
SWIN = [(B, C, heads, H) for B in (1, 2, 16, 64, 72) for C, heads, H in STAGES]
# vit_mlp_bwd: every VIT_TRAIN_SHAPES entry of chip_smoke.py (Audio-MAE CP,
# OPERA-GT CP at 320 and 80 tokens, operaGT fine-tuning) and one 64-token tile
VIT = [(64 * 160, 768), (64 * 320, 384), (64 * 80, 384), (4 * 1040, 384), (64, 384), (64, 768)]
MLP_CASES = [(B * H * H, C, True) for B, C, _, H in SWIN] + [(n, C, False) for n, C in VIT]


def _ids(cases):
    return ["-".join(map(str, c)) for c in cases]


def _mlp_plan(n, C, kmul):
    return swin_plan.mlp_bwd_plan(n, C, 4 * C, SMS, kmul)


def _cover(ranges, total):
    """Each of [0, total) in exactly one of the [a, b) ranges, in order."""
    seen = np.zeros(total, int)
    for a, b in ranges:
        assert a <= b
        seen[a:b] += 1
    assert (seen == 1).all()
    assert [r[0] for r in ranges] == sorted(r[0] for r in ranges)


@pytest.mark.parametrize("n,C,kmul", MLP_CASES, ids=_ids(MLP_CASES))
def test_mlp_bwd_plan_covers_each_unit_once(n, C, kmul):
    """Every (panel, hidden chunk) unit is one chunk-kernel block's, in a
    contiguous run, and every chunk-kernel block has work; every 32-token
    tile is one row-pass block's."""
    plan = _mlp_plan(n, C, kmul)
    runs = [r for _, r in plan.blocks()]
    _cover(runs, plan.units)
    assert all(b > a for a, b in runs)
    assert plan.units == -(-n // plan.panel_rows) * (4 * C // plan.hidden_chunk)
    _cover([r for _, r in plan.rp_blocks()], n // swin_plan.RP_TOKENS)


@pytest.mark.parametrize("n,C,kmul", MLP_CASES, ids=_ids(MLP_CASES))
def test_mlp_bwd_plan_fits_the_card(n, C, kmul):
    """Shared memory within the block limit, the accumulators within the
    register budget, the partial rows the wrapper allocates, and a grid
    that fills the card wherever the units can."""
    plan = _mlp_plan(n, C, kmul)
    assert 2 <= plan.stages <= swin_plan.MAX_BWD_STAGES
    assert plan.smem_bytes <= swin_plan.SMEM_LIMIT
    assert plan.acc_floats <= swin_plan.REG_BUDGET
    assert 1 <= plan.grid <= min(plan.units, SMS)
    assert plan.panel_rows == (128 if C <= 192 else 64)
    assert plan.stream_dy == (C == 768)
    # a row-pass block for each partial row of the chunk kernel: the
    # wrapper allocates exactly those rows
    assert plan.part_rows == plan.grid * plan.rows_per_block == plan.rp_grid
    assert plan.part_cols == 4 * C + 3 * C
    if plan.units >= SMS:
        assert plan.grid == SMS


def test_mlp_bwd_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        swin_plan.mlp_bwd_plan(96, 96, 384, SMS)  # not whole 64-token tiles
    with pytest.raises(ValueError):
        swin_plan.mlp_bwd_plan(64, 128, 512, SMS)  # width
    with pytest.raises(ValueError):
        swin_plan.mlp_bwd_plan(64, 384, 1600, SMS)  # hidden
    with pytest.raises(ValueError):
        swin_plan.mlp_bwd_plan(64, 768, 3072, SMS, kmul=True)  # dy streams: no multiplier


@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("B,C,heads,H", SWIN, ids=_ids(SWIN))
def test_attn_bwd_plan_covers_each_window_and_token_once(B, C, heads, H, shift):
    """Every window is one block's, in contiguous runs; every 32-token tile
    one row-pass block's, and the row pass's window order reaches every token of
    (B, H, W) exactly once under the shift (the kernel's RowMap)."""
    plan = swin_plan.attn_bwd_plan(B, H, H, C, heads, SMS)
    runs = [r for _, r in plan.blocks()]
    _cover(runs, plan.windows)
    assert all(b > a for a, b in runs)
    _cover([r for _, r in plan.rp_blocks()], plan.n_tokens // swin_plan.RP_TOKENS)
    r = np.arange(plan.n_tokens)
    w, t = r // 64, r % 64
    nww = H // 8
    nws = nww * nww
    b, win = w // nws, w % nws
    rr = ((win // nww) * 8 + t // 8 + shift) % H
    cc = ((win % nww) * 8 + t % 8 + shift) % H
    tok = (b * H + rr) * H + cc
    assert np.array_equal(np.sort(tok), np.arange(B * H * H))


@pytest.mark.parametrize("B,C,heads,H", SWIN, ids=_ids(SWIN))
def test_attn_bwd_plan_fits_the_card(B, C, heads, H):
    plan = swin_plan.attn_bwd_plan(B, H, H, C, heads, SMS)
    assert 2 <= plan.stages <= swin_plan.MAX_BWD_STAGES
    assert plan.smem_bytes <= swin_plan.SMEM_LIMIT
    assert plan.acc_floats <= swin_plan.REG_BUDGET
    assert 1 <= plan.grid <= min(plan.windows, SMS)
    assert plan.part_rows == plan.grid * plan.rows_per_block == plan.rp_grid
    assert plan.part_cols == heads * 4096 + 3 * heads * 32 + 3 * C
    if plan.windows >= SMS:
        assert plan.grid == SMS


def test_attn_bwd_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        swin_plan.attn_bwd_plan(1, 8, 8, 768, 32, SMS)  # stage 3 trains as a plain block
    with pytest.raises(ValueError):
        swin_plan.attn_bwd_plan(1, 12, 8, 96, 4, SMS)  # H not whole windows
    with pytest.raises(ValueError):
        swin_plan.attn_bwd_plan(1, 8, 8, 96, 3, SMS)  # an odd head count


def test_bwd_plan_constants_match_the_sources():
    """The plans' layout constants are the kernels' own."""
    csrc = Path(swin_plan.__file__).resolve().parent.parent / "csrc"
    mlp = (csrc / "swin_mlp_bwd.cu").read_text()
    attn = (csrc / "swin_attn_bwd.cu").read_text()
    common = (csrc / "swin_bwd_common.cuh").read_text()
    num = lambda src, name: int(re.search(rf"\b{name}\s*=\s*(\d+)", src).group(1))
    assert num(common, "RP_TOKENS") == swin_plan.RP_TOKENS
    assert num(attn, "TILES") == swin_plan.ATTN_BWD_TILES
    assert "HSTAGE = 4 * HDP * 128" in attn and swin_plan.HSTAGE == 4 * 32 * 128
    assert "RPB = C == 96 ? 4 : C == 192 ? 2 : 1" in attn
    assert num(common, "RP_THREADS") == 512  # 8 groups of 48 column pairs at C = 96
    assert "PR = ROWS ? 128 : 64" in mlp and "HN = ROWS ? 64 : 128" in mlp
    assert "STREAM = C == 768" in mlp and "RPB = ROWS ? 8 : 4" in mlp
    assert "STAGE = 2 * W_BYTES + (STREAM ? PR * 128 : 0)" in mlp
    for src in (mlp, attn, common):
        assert "nvcuda::wmma" not in src and "wmma::" not in src
        # no cluster (size 1 <= 8): a unit or window needs no other block's sums
        assert "ClusterDimension" not in src


# ---------------------------------------------------------------------------
# float32 models of the kernels' column-sum orders
# ---------------------------------------------------------------------------


def _warp_tree(v):
    """A warp's sum of 16 rows (16, cols) as the kernels take it: each
    thread's two rows g and g + 8, then a shuffle tree over g (xor 1, 2, 4
    of g: pairs, then pairs of pairs)."""
    a = v[:8] + v[8:]
    a = a[0::2] + a[1::2]
    a = a[0::2] + a[1::2]
    return a[0] + a[1]


def _db1_model(da1, plan):
    """db1 as swin_mlp_bwd sums it: each chunk-kernel block's warp rows over
    its run of units in order (a warp's 16 rows by _warp_tree), then
    swin_reduce over the partial rows in order."""
    n, hid = da1.shape
    pr, hn = plan.panel_rows, plan.hidden_chunk
    rpb = plan.rows_per_block
    rows = torch.zeros(plan.part_rows, hid, dtype=torch.float32)
    for blk, (u0, u1) in plan.blocks():
        for u in range(u0, u1):
            p, c = divmod(u, plan.chunks)
            for wg in range(2):
                for wq in range(4):
                    r0 = p * pr + (64 * wg if plan.rows_mode else 0) + 16 * wq
                    cols = slice(c * hn + (0 if plan.rows_mode else 64 * wg),
                                 c * hn + (0 if plan.rows_mode else 64 * wg) + 64)
                    tile = torch.zeros(16, 64)
                    got = da1[r0:min(r0 + 16, n), cols]
                    tile[:got.shape[0]] = got
                    row = blk * rpb + (4 * wg + wq if plan.rows_mode else wq)
                    rows[row, cols] = rows[row, cols] + _warp_tree(tile)
    out = rows[0].clone()
    for i in range(1, rows.shape[0]):
        out += rows[i]
    return out


@pytest.mark.parametrize("n,C", [(64 * 3, 96), (128 * 5, 384)])
def test_db1_ordered_sum_model_matches_ref(n, C):
    """The float32 model of swin_mlp_bwd's db1 order (a few units a block on
    a card of 4 SMs, a last panel half past the tokens at C = 96) agrees
    with the float64 column sum."""
    g = torch.Generator().manual_seed(n)
    da1 = torch.randn(n, 4 * C, generator=g)
    plan = swin_plan.mlp_bwd_plan(n, C, 4 * C, 4)
    assert plan.grid == 4 and plan.units > 4
    got = _db1_model(da1, plan)
    want = da1.double().sum(0)
    assert torch.allclose(got.double(), want, rtol=0, atol=1e-4 * float(want.abs().max()))


def test_row_pass_and_dbias_order_models_match_ref():
    """The row pass's order (a block's run of 32-token tiles; a group of
    threads a share of each tile's tokens, in tile and token order; the
    groups in order; then swin_reduce over the rows) and swin_attn_bwd's
    dbias order (a block's windows in order, element by element, then the
    rows in order) agree with the float64 sums."""
    g = torch.Generator().manual_seed(3)
    n, C, grid = 64 * 40, 96, 7
    groups = 8  # at C = 96: 48 column pairs, 512 threads (RowsCfg)
    d = torch.randn(n, C, generator=g)
    rows = torch.zeros(grid, C)
    for b, (t0, t1) in swin_plan._rp_runs(n, grid):
        red = torch.zeros(groups, C)
        for tile in range(t0, t1):
            for grp in range(groups):
                for t in range(grp * 32 // groups, (grp + 1) * 32 // groups):
                    red[grp] += d[32 * tile + t]
        rows[b] = red[0]
        for grp in range(1, groups):
            rows[b] += red[grp]
    got = rows[0].clone()
    for i in range(1, grid):
        got += rows[i]
    assert torch.allclose(got.double(), d.double().sum(0), atol=1e-4 * float(d.abs().sum(0).max()))
    ds = torch.randn(37, 4, 64, 64, generator=g)  # windows x heads x 64 x 64
    plan = swin_plan.attn_bwd_plan(1, 8, 8 * 37, 96, 4, 5)
    assert plan.windows == 37 and plan.grid == 5
    part = torch.zeros(plan.grid, 4, 64, 64)
    for blk, (w0, w1) in plan.blocks():
        for w in range(w0, w1):
            part[blk] = ds[w] if w == w0 else part[blk] + ds[w]
    got = part[0].clone()
    for i in range(1, plan.grid):
        got += part[i]
    want = ds.double().sum(0)
    assert torch.allclose(got.double(), want, atol=1e-4 * float(want.abs().max()))
