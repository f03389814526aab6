"""Launch plans of the kernels of the swin and ViT blocks, computed on the
host in one place: the wgmma forward kernels csrc/swin_mlp.cu (swin_mlp,
and vit_mlp with LN eps 1e-6) and csrc/swin_attn.cu (swin_attn), the
backward kernels csrc/swin_mlp_bwd.cu (swin_mlp_bwd and vit_mlp_bwd) and
csrc/swin_attn_bwd.cu (swin_attn_bwd), the float32 forward kernels
csrc/swin_attn_f32.cu and csrc/swin_mlp_f32.cu (fixed tiles: a core block
a (window, head), a product block a 64 x 96 output tile) and the float32
backward kernels (below). The wrappers in
ops/swin.py, ops/vit.py, ops/swin_train.py and ops/vit_train.py pass a
plan's numbers to the launch, which checks them against the kernel's
compiled configuration; the CPU tests (tests/test_torch_swin_plan.py,
tests/test_torch_bwd_plan.py, tests/test_torch_swin_f32.py,
tests/test_torch_swin_train_f32.py) enumerate the plans of every geometry
the towers launch.

swin_mlp: a block owns a panel of token rows (128 at C <= 192, where each
warpgroup holds 64 rows and every output column; 64 at C >= 384, where the
two warpgroups split the block's output columns), the block's output columns
(all of C; half of it at C = 768: two blocks a panel, each recomputing
fc1), and a share of the hidden chunks: a cluster of `ks` blocks over the hidden
dimension, whose fc2 sums are added in rank order.

swin_attn: a block owns two windows at C <= 192 (a warpgroup a window) or
one at C >= 384 (the warpgroups take two heads at a time), and a share of
the window's heads: a cluster of `cs` blocks, each of which then computes
proj for C / cs output columns.

The cluster sizes come from the grid and the SM count: the fewest waves,
counting a block of a k-block cluster as 1 / k of the work plus what the
split adds (the partial sums or the gathered head outputs, the repeated
LayerNorm), as vit_qkv.cu splits its columns.

The backward kernels are persistent: one block an SM (their shared memory
holds one), each walking a fixed, contiguous run of work in order, so every
column sum has one order fixed by the shapes and the SM count.
swin_mlp_bwd's chunk kernel walks (panel, hidden chunk) units, panel-major
(a panel of 128 token rows at C <= 192, 64 above; a chunk of 64 or 128
hidden columns), reloading and normalising a panel where its run enters a
new one; swin_attn_bwd's window kernel walks windows, two heads at a time.
After each, a row pass (32-token tiles, a contiguous run of tiles a block)
applies the LayerNorm backward. The float32 partial rows that swin_reduce
sums are the chunk kernel's (one a warp's rows of a block: 8 a block at
C <= 192, 4 above) or the window kernel's (4, 2, 1 a block at C = 96, 192,
384); the row pass has a block for each of them, which fills the row's
last 3 C columns.

The float32 backward kernels (csrc/swin_mlp_bwd_f32.cu,
csrc/swin_attn_bwd_f32.cu, csrc/swin_wgrad_f32.cu) split their work by
fixed numbers rather than the SM count, so that every sum's order depends
on the shapes alone: the MLP row pass over F32_MLP_BWD_ROWS contiguous
token runs (its partial rows), the attention core over about
F32_ATTN_BWD_BLOCKS (window run, head) blocks (the runs are its partial
rows, and the row pass has a block for each), the weight products over
about F32_WGRAD_BLOCKS (96 x 96 tile, token chunk) blocks. Nothing here
touches a card.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

SMEM_LIMIT = 232448  # dynamic shared memory a block can have on sm_90
MAX_CLUSTER = 8  # the portable cluster size
# accumulator floats and register A fragments a consumer thread holds at once:
# a 288-thread block an SM leaves 224 registers a thread
REG_BUDGET = 160
WIDTHS = (96, 192, 384, 768)  # the swin blocks' widths (swin_attn and the backward kernels)

MLP_STAGE = 16384  # bytes of a ring stage (csrc/swin_mlp.cu)
W2_ROWS = 96  # output rows of a W2 box
# csrc/swin_mlp.cu's MlpCfg by width: the output columns of a block
MLP_LAYOUT = {96: 96, 192: 192, 384: 384, 768: 384}
# swin_mlp also runs the MAE encoders' ViT MLP (vit_mlp; HeAR's C 1024 runs
# csrc/vit_rows.cu, ops/vit_plan.py)
MLP_WIDTHS = tuple(MLP_LAYOUT)
PART_PAD = 8  # float32 padding of a parked row of fc2 sums
MLP_SPLIT_COST = 0.1  # a hidden split's extra work, as a share of a whole block's

HDP = 32  # head dim padded (the kernel's q / k / v columns a head)
HEADBUF = 64 * 128 + HDP * 128  # a warpgroup's k and v^T tiles (csrc/swin_attn.cu)
ATTN_SPLIT_COST = 0.15  # a head split's extra work, as a share of a whole block's


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pick(units: int, options, sms: int, cost: float) -> int:
    """The option k (blocks a work unit) of the fewest waves, a block of a
    split unit counting 1 / k + cost; ties go to the smaller k."""
    def waves(k):
        return _cdiv(units * k, sms) * (1.0 / k + (cost if k > 1 else 0.0))
    return min(options, key=lambda k: (waves(k), k))


@dataclasses.dataclass(frozen=True)
class MlpPlan:
    C: int
    hidden: int
    n_tokens: int
    panel_rows: int  # token rows of a block
    hidden_chunk: int  # hidden columns of a fc1 / fc2 step
    out_cols: int  # output columns of a block
    out_splits: int  # blocks a panel over the output columns (C / out_cols)
    ks: int  # blocks of a cluster over the hidden chunks
    stages: int  # ring depth

    @property
    def rows_mode(self) -> bool:
        return self.C <= 192

    @property
    def panels(self) -> int:
        return _cdiv(self.n_tokens, self.panel_rows)

    @property
    def grid(self) -> int:
        return self.panels * self.out_splits * self.ks

    @property
    def panel_bytes(self) -> int:
        return _cdiv(self.C, 64) * self.panel_rows * 128

    @property
    def ring_offset(self) -> int:
        # columns mode: the GELU chunk, double-buffered
        g = 0 if self.rows_mode else 2 * (self.hidden_chunk // 64) * 64 * 128
        return self.panel_bytes + g

    @property
    def smem_bytes(self) -> int:
        return self.ring_offset + self.stages * MLP_STAGE + 8 * (1 + 2 * self.stages) + 1024

    @property
    def parked_bytes(self) -> int:
        """The float32 fc2 sums a block parks over its panel and ring."""
        return self.panel_rows * (self.out_cols + PART_PAD) * 4

    @property
    def acc_floats(self) -> int:
        """fc2 accumulators, fc1 accumulators and (rows mode) the GELU
        chunk's register A fragments of one consumer thread."""
        per_wg_out = self.out_cols if self.rows_mode else self.out_cols // 2
        fc1 = self.hidden_chunk if self.rows_mode else self.hidden_chunk // 2
        frags = fc1 // 4 if self.rows_mode else 0  # bf16 pairs
        return per_wg_out // 2 + fc1 // 2 + frags

    def blocks(self) -> List[Tuple[int, Tuple[int, int], Tuple[int, int], Tuple[int, int], int]]:
        """(block, token rows, output columns, hidden columns, rank) of each
        block, by the kernel's index arithmetic: blockIdx.x = (panel *
        out_splits + ns) * ks + rank."""
        out = []
        share = self.hidden // self.ks
        for blk in range(self.grid):
            rank = blk % self.ks
            ns = (blk // self.ks) % self.out_splits
            p0 = (blk // self.ks // self.out_splits) * self.panel_rows
            rows = (p0, min(p0 + self.panel_rows, self.n_tokens))
            cols = (ns * self.out_cols, (ns + 1) * self.out_cols)
            out.append((blk, rows, cols, (rank * share, (rank + 1) * share), rank))
        return out

    def epilogue_rows(self, rank: int) -> Tuple[int, int]:
        """The panel rows whose sums block `rank` of a cluster adds up."""
        return rank * self.panel_rows // self.ks, (rank + 1) * self.panel_rows // self.ks


def mlp_plan(n_tokens: int, C: int, hidden: int, sms: int) -> MlpPlan:
    """The swin_mlp launch for n_tokens rows of width C on a card of `sms`
    SMs; a ValueError for a geometry the kernel does not take."""
    if C not in MLP_WIDTHS or n_tokens <= 0 or sms <= 0:
        raise ValueError(f"the MLP kernel takes C in {MLP_WIDTHS} and n_tokens > 0, got C {C}, "
                         f"n_tokens {n_tokens}")
    return _mlp_plan(n_tokens, C, hidden, sms)


@functools.lru_cache(maxsize=256)
def _mlp_plan(n_tokens: int, C: int, hidden: int, sms: int) -> MlpPlan:
    rows = C <= 192
    chunk = 64 if C == 192 else 128
    if hidden <= 0 or hidden % chunk:
        raise ValueError(f"the MLP kernel takes hidden a multiple of {chunk} at C {C}, "
                         f"got {hidden}")
    pr = 128 if rows else 64
    nb = MLP_LAYOUT[C]
    ns = C // nb
    panels = _cdiv(n_tokens, pr)
    chunks = hidden // chunk
    ks = _pick(panels * ns, [k for k in range(1, MAX_CLUSTER + 1) if chunks % k == 0], sms,
               MLP_SPLIT_COST)
    plan = MlpPlan(C, hidden, n_tokens, pr, chunk, nb, ns, ks, 2)
    stages = min(8, (SMEM_LIMIT - plan.ring_offset - 8 - 1024) // (MLP_STAGE + 16))
    return dataclasses.replace(plan, stages=stages)


@dataclasses.dataclass(frozen=True)
class AttnPlan:
    B: int
    H: int
    W: int
    C: int
    heads: int
    windows_per_block: int
    cs: int  # blocks of a cluster over a window's heads
    proj_width: int  # output columns of a warpgroup's proj pass (96 or 48)
    stages: int

    @property
    def windows(self) -> int:
        return self.B * (self.H // 8) * (self.W // 8)

    @property
    def grid(self) -> int:
        return _cdiv(self.windows, self.windows_per_block) * self.cs

    @property
    def rows(self) -> int:
        return 64 * self.windows_per_block

    @property
    def stage_bytes(self) -> int:
        heads_a_stage = 1 if self.windows_per_block == 2 else 2
        return heads_a_stage * 3 * HDP * 128

    @property
    def proj_rows(self) -> int:
        """W_proj rows of a proj stage: the pass's output columns."""
        return self.proj_width * (1 if self.windows_per_block == 2 else 2)

    @property
    def smem_bytes(self) -> int:
        return _attn_smem(self.C, self.rows, self.cs, self.stage_bytes, self.stages)

    @property
    def acc_floats(self) -> int:
        """The largest accumulator set of a consumer thread: the head's
        q / k / v (m64n96) and q's fragments, the scores and P's fragments,
        or a proj pass."""
        return max(48 + 8, 32 + 16 + 16, self.proj_width // 2)

    def blocks(self) -> List[Tuple[int, Tuple[int, ...], Tuple[int, ...], Tuple[int, int], int]]:
        """(block, global windows, heads, output columns, rank) of each block,
        by the kernel's index arithmetic: blockIdx.x = group * cs + rank."""
        out = []
        hpb, cb = self.heads // self.cs, self.C // self.cs
        for blk in range(self.grid):
            rank, group = blk % self.cs, blk // self.cs
            wins = tuple(w for w in range(group * self.windows_per_block,
                                          (group + 1) * self.windows_per_block)
                         if w < self.windows)
            out.append((blk, wins, tuple(range(rank * hpb, (rank + 1) * hpb)),
                        (rank * cb, (rank + 1) * cb), rank))
        return out


def _attn_smem(C: int, rows: int, cs: int, stage: int, stages: int) -> int:
    panel = _cdiv(C, 64) * rows * 128
    o = _cdiv(C // cs, 64) * rows * 128
    return panel + o + 2 * HEADBUF + stages * stage + 16 * stages + 1024


def attn_plan(B: int, H: int, W: int, C: int, heads: int, sms: int) -> AttnPlan:
    """The swin_attn launch for x (B, H, W, C) with `heads` heads on a card
    of `sms` SMs; a ValueError for a geometry the kernel does not take."""
    if C not in WIDTHS or B <= 0 or H <= 0 or W <= 0 or H % 8 or W % 8 or sms <= 0:
        raise ValueError(f"the attention kernel takes C in {WIDTHS} and H, W multiples of 8, "
                         f"got {(B, H, W, C)}")
    return _attn_plan(B, H, W, C, heads, sms)


@functools.lru_cache(maxsize=256)
def _attn_plan(B: int, H: int, W: int, C: int, heads: int, sms: int) -> AttnPlan:
    if heads <= 0 or C % heads or C // heads > HDP or (C // heads) % 8:
        raise ValueError(f"the attention kernel takes a head dim of 8-32 in steps of 8, got "
                         f"C {C} with {heads} heads")
    wpb = 2 if C <= 192 else 1
    hd = C // heads
    stage = (1 if wpb == 2 else 2) * 3 * HDP * 128

    def fit(cs, pw):
        """The ring depth at cluster size cs, or 0 where it does not fit."""
        fixed = _attn_smem(C, 64 * wpb, cs, stage, 0)
        return min(8, max(0, (SMEM_LIMIT - fixed) // (stage + 16)))

    options = {}
    if wpb == 2:
        options[1] = 96
    else:
        for cs in range(1, MAX_CLUSTER + 1):
            hpb, cb = heads // cs, C // cs
            if heads % cs or hpb % 2 or (hd * hpb) % 8:
                continue
            pw = 96 if cb % 192 == 0 else 48 if cb % 96 == 0 else 0
            if pw and fit(cs, pw) >= 2:
                options[cs] = pw
    if not options:
        raise ValueError(f"no launch of the attention kernel fits C {C} with {heads} heads")
    windows = B * (H // 8) * (W // 8)
    cs = _pick(_cdiv(windows, wpb), sorted(options), sms, ATTN_SPLIT_COST)
    return AttnPlan(B, H, W, C, heads, wpb, cs, options[cs], fit(cs, options[cs]))


# ---------------------------------------------------------------------------
# the float32 forward kernels (csrc/swin_attn_f32.cu, csrc/swin_mlp_f32.cu)
# ---------------------------------------------------------------------------

F32_TILE_ROWS = 64  # token rows of a product block (csrc/swin_f32_common.cuh GBM)
F32_TILE_COLS = 96  # output columns of a product block (GBN)
F32_TILE_K = 16  # k depth of a product step (GBK)
F32_THREADS = 128  # threads of a product block and of an attention core block
F32_HD = 24  # the head dim the attention core takes (every HTS-AT stage's)
F32_CORE_K = 32  # k depth of the core's qkv step (ABK)


@dataclasses.dataclass(frozen=True)
class GemmF32Plan:
    """One launch of the float32 token-row product: M rows of N outputs
    over K, a block a (64 rows, 96 columns) tile."""

    M: int
    N: int
    K: int

    @property
    def grid(self) -> Tuple[int, int]:
        """(row tiles, column tiles); the last row tile is partial where M is
        not a multiple of 64 (the ViT eval products, ops/vit_plan.py)."""
        return _cdiv(self.M, F32_TILE_ROWS), self.N // F32_TILE_COLS

    @property
    def smem_bytes(self) -> int:
        # the k-major A and W tiles (rows padded by 4 floats) and the row statistics
        return 4 * (F32_TILE_K * (F32_TILE_ROWS + 4) + F32_TILE_K * (F32_TILE_COLS + 4)
                    + 2 * F32_TILE_ROWS)

    def tiles(self) -> List[Tuple[Tuple[int, int], Tuple[int, int]]]:
        """(rows, columns) of each block, by the kernel's index arithmetic
        (rows past M are not stored)."""
        gx, gy = self.grid
        return [((bx * F32_TILE_ROWS, min(self.M, (bx + 1) * F32_TILE_ROWS)),
                 (by * F32_TILE_COLS, (by + 1) * F32_TILE_COLS))
                for bx in range(gx) for by in range(gy)]


def _gemm_f32(M: int, N: int, K: int) -> GemmF32Plan:
    if M <= 0 or M % F32_TILE_ROWS or N <= 0 or N % F32_TILE_COLS or K <= 0 or K % F32_TILE_K:
        raise ValueError(f"the float32 product takes rows in 64s, columns in 96s and a depth "
                         f"in 16s, got ({M}, {N}, {K})")
    return GemmF32Plan(M, N, K)


@dataclasses.dataclass(frozen=True)
class AttnF32Plan:
    B: int
    H: int
    W: int
    C: int
    heads: int
    proj: GemmF32Plan  # the second launch: o (windows x 64, C) times W_proj^T

    @property
    def windows(self) -> int:
        return self.B * (self.H // 8) * (self.W // 8)

    @property
    def core_grid(self) -> Tuple[int, int]:
        """(windows, heads): a core block a window's head."""
        return self.windows, self.heads

    @property
    def core_smem_bytes(self) -> int:
        # token offsets; the qkv tiles, aliased by the 64 x 65 scores; q^T
        # (rows padded by 4), k^T, v; the row statistics and reciprocals
        tiles = F32_CORE_K * 68 + F32_CORE_K * (3 * F32_HD + 4)
        region = max(tiles, 64 * 65)
        return 8 * 64 + 4 * (region + F32_HD * 68 + 2 * F32_HD * 64 + 3 * 64)

    @property
    def workspace_shape(self) -> Tuple[int, int]:
        return self.windows * 64, self.C


def attn_f32_plan(B: int, H: int, W: int, C: int, heads: int) -> AttnF32Plan:
    """The swin_attn_f32 launches for x (B, H, W, C) with `heads` heads; a
    ValueError for a geometry the kernels do not take."""
    if C not in WIDTHS or B <= 0 or H <= 0 or W <= 0 or H % 8 or W % 8:
        raise ValueError(f"the float32 attention kernel takes C in {WIDTHS} and H, W multiples "
                         f"of 8, got {(B, H, W, C)}")
    if heads * F32_HD != C:
        raise ValueError(f"the float32 attention kernel takes a head dim of {F32_HD}, got C {C} "
                         f"with {heads} heads")
    return AttnF32Plan(B, H, W, C, heads, _gemm_f32(B * H * W, C, C))


@dataclasses.dataclass(frozen=True)
class MlpF32Plan:
    n_tokens: int
    C: int
    hidden: int
    fc1: GemmF32Plan  # LN2(x) W_fc1^T + b_fc1, GELU -> the workspace (n, hidden)
    fc2: GemmF32Plan  # the workspace W_fc2^T + b_fc2, times k, + x

    @property
    def workspace_shape(self) -> Tuple[int, int]:
        return self.n_tokens, self.hidden


def mlp_f32_plan(n_tokens: int, C: int, hidden: int) -> MlpF32Plan:
    """The swin_mlp_f32 launches for n_tokens rows of width C; a ValueError
    for a geometry the kernels do not take."""
    if C not in WIDTHS:
        raise ValueError(f"the float32 MLP kernel takes C in {WIDTHS}, got {C}")
    return MlpF32Plan(n_tokens, C, hidden, _gemm_f32(n_tokens, hidden, C),
                      _gemm_f32(n_tokens, C, hidden))


# ---------------------------------------------------------------------------
# the backward kernels
# ---------------------------------------------------------------------------

RP_TOKENS = 32  # tokens a tile of the backward row pass (csrc/swin_bwd_common.cuh)
MAX_BWD_STAGES = 8
BAR_SLACK = 1024  # the 1024-byte alignment of the dynamic shared memory
HSTAGE = 4 * HDP * 128  # swin_attn_bwd: a head's ring stage (q, k, v, W_proj^T boxes)
ATTN_BWD_TILES = 40960  # swin_attn_bwd: a warpgroup's head tiles


def _rp_runs(n_tokens: int, grid: int) -> List[Tuple[int, Tuple[int, int]]]:
    """(block, [first, last) 32-token tile) of each row-pass block: block b
    of G walks [b T / G, (b + 1) T / G) of the T tiles (some may be empty)."""
    tiles = n_tokens // RP_TOKENS
    return [(b, (tiles * b // grid, tiles * (b + 1) // grid)) for b in range(grid)]


@dataclasses.dataclass(frozen=True)
class MlpBwdPlan:
    C: int
    hidden: int
    n_tokens: int
    panel_rows: int  # token rows of a panel
    hidden_chunk: int  # hidden columns of a unit
    stream_dy: bool  # dy through the ring (C = 768) instead of a held panel
    stages: int  # ring depth
    grid: int  # chunk-kernel blocks

    @property
    def rows_mode(self) -> bool:
        return self.C <= 192

    @property
    def panels(self) -> int:
        return _cdiv(self.n_tokens, self.panel_rows)

    @property
    def chunks(self) -> int:
        return self.hidden // self.hidden_chunk

    @property
    def units(self) -> int:
        return self.panels * self.chunks

    @property
    def rows_per_block(self) -> int:
        """db1 partial rows of a chunk-kernel block: one a warp's 16 rows."""
        return 8 if self.rows_mode else 4

    @property
    def part_rows(self) -> int:
        """The partial rows: the chunk kernel's; the row pass has a block
        for each."""
        return self.grid * self.rows_per_block

    @property
    def rp_grid(self) -> int:
        return self.part_rows

    @property
    def part_cols(self) -> int:
        return self.hidden + 3 * self.C

    @property
    def panel_bytes(self) -> int:
        return _cdiv(self.C, 64) * self.panel_rows * 128

    @property
    def stage_bytes(self) -> int:
        return 2 * self.hidden_chunk * 128 + (self.panel_rows * 128 if self.stream_dy else 0)

    @property
    def smem_bytes(self) -> int:
        held = 1 if self.stream_dy else 2
        return held * self.panel_bytes + self.stages * self.stage_bytes + 8 * (2 + 2 * self.stages) \
            + BAR_SLACK

    @property
    def acc_floats(self) -> int:
        """a1 and dg accumulators (m64n64 each) of one consumer thread."""
        return 2 * 32

    def blocks(self) -> List[Tuple[int, Tuple[int, int]]]:
        """(block, [first, last) unit) of each chunk-kernel block, by the
        kernel's arithmetic; unit u is (panel u // chunks, chunk u % chunks)."""
        return [(b, (self.units * b // self.grid, self.units * (b + 1) // self.grid))
                for b in range(self.grid)]

    def rp_blocks(self) -> List[Tuple[int, Tuple[int, int]]]:
        return _rp_runs(self.n_tokens, self.rp_grid)


def mlp_bwd_plan(n_tokens: int, C: int, hidden: int, sms: int, kmul: bool = True) -> MlpBwdPlan:
    """The swin_mlp_bwd / vit_mlp_bwd launch for n_tokens rows of width C
    on a card of `sms` SMs (kmul: with a per-sample multiplier); a
    ValueError for a geometry the kernels do not take."""
    if C not in WIDTHS or n_tokens <= 0 or n_tokens % 64 or sms <= 0 or hidden != 4 * C:
        raise ValueError(f"the MLP backward takes C in {WIDTHS}, hidden 4 C and n_tokens a "
                         f"multiple of 64, got C {C}, hidden {hidden}, n_tokens {n_tokens}")
    if C == 768 and kmul:
        raise ValueError("the MLP backward streams dy at C = 768 and takes no multiplier there")
    return _mlp_bwd_plan(n_tokens, C, hidden, sms)


@functools.lru_cache(maxsize=256)
def _mlp_bwd_plan(n_tokens: int, C: int, hidden: int, sms: int) -> MlpBwdPlan:
    rows = C <= 192
    pr, chunk, stream = (128 if rows else 64), (64 if rows else 128), C == 768
    plan = MlpBwdPlan(C, hidden, n_tokens, pr, chunk, stream, 0, 1)
    fixed = plan.smem_bytes - 16  # the panels, two barriers and the slack
    stages = min(MAX_BWD_STAGES, (SMEM_LIMIT - fixed) // (plan.stage_bytes + 16))
    return dataclasses.replace(plan, stages=stages, grid=min(plan.units, sms))


@dataclasses.dataclass(frozen=True)
class AttnBwdPlan:
    B: int
    H: int
    W: int
    C: int
    heads: int
    stages: int
    grid: int  # window-kernel blocks

    @property
    def windows(self) -> int:
        return self.B * (self.H // 8) * (self.W // 8)

    @property
    def n_tokens(self) -> int:
        return 64 * self.windows

    @property
    def rows_per_block(self) -> int:
        """Partial rows of a window-kernel block (its dbias and db_qkv in
        the first): more at C <= 192, whose row pass covers more tokens."""
        return {96: 4, 192: 2}.get(self.C, 1)

    @property
    def part_rows(self) -> int:
        """The partial rows: the window kernel's; the row pass has a block
        for each."""
        return self.grid * self.rows_per_block

    @property
    def rp_grid(self) -> int:
        return self.part_rows

    @property
    def part_cols(self) -> int:
        return self.heads * 64 * 64 + 3 * self.heads * HDP + 3 * self.C

    @property
    def panel_bytes(self) -> int:
        return _cdiv(self.C, 64) * 64 * 128

    @property
    def smem_bytes(self) -> int:
        return 2 * self.panel_bytes + 2 * ATTN_BWD_TILES + self.stages * (HSTAGE + 16) + BAR_SLACK

    @property
    def acc_floats(self) -> int:
        """The largest set of a consumer thread: the head's q / k / v and do
        (m64n96, m64n32) with the prefetched bias and mask; the scores, dP
        and the dbias partials; or the four window products with P's and
        dS's fragments and the mask."""
        return max(48 + 16 + 32 + 32, 32 + 32 + 32 + 32, 4 * 16 + 2 * 16 + 32)

    def blocks(self) -> List[Tuple[int, Tuple[int, int]]]:
        """(block, [first, last) window) of each window-kernel block."""
        return [(b, (self.windows * b // self.grid, self.windows * (b + 1) // self.grid))
                for b in range(self.grid)]

    def rp_blocks(self) -> List[Tuple[int, Tuple[int, int]]]:
        return _rp_runs(self.n_tokens, self.rp_grid)


def attn_bwd_plan(B: int, H: int, W: int, C: int, heads: int, sms: int) -> AttnBwdPlan:
    """The swin_attn_bwd launch for x (B, H, W, C) with `heads` heads on a
    card of `sms` SMs; a ValueError for a geometry the kernel does not take."""
    if C not in WIDTHS[:3] or B <= 0 or H <= 0 or W <= 0 or H % 8 or W % 8 or sms <= 0:
        raise ValueError(f"the attention backward takes C in {WIDTHS[:3]} and H, W multiples of "
                         f"8, got {(B, H, W, C)}")
    if heads <= 0 or heads % 2 or C % heads or C // heads > HDP or (C // heads) % 8:
        raise ValueError(f"the attention backward takes an even head count and a head dim of "
                         f"8-32 in steps of 8, got C {C} with {heads} heads")
    return _attn_bwd_plan(B, H, W, C, heads, sms)


@functools.lru_cache(maxsize=256)
def _attn_bwd_plan(B: int, H: int, W: int, C: int, heads: int, sms: int) -> AttnBwdPlan:
    plan = AttnBwdPlan(B, H, W, C, heads, 0, 1)
    stages = min(MAX_BWD_STAGES, (SMEM_LIMIT - plan.smem_bytes) // (HSTAGE + 16))
    return dataclasses.replace(plan, stages=stages, grid=min(plan.windows, sms))


# ---------------------------------------------------------------------------
# the float32 backward kernels (csrc/swin_mlp_bwd_f32.cu,
# csrc/swin_attn_bwd_f32.cu, csrc/swin_wgrad_f32.cu)
# ---------------------------------------------------------------------------

F32_ROW_THREADS = 256  # the LayerNorm row kernels: a warp a token (RTHREADS)
F32_ROW_WARPS = F32_ROW_THREADS // 32
# blocks of the row pass of swin_mlp_bwd_f32 (its partial rows); of the
# core of swin_attn_bwd_f32 over its (window run, head) pairs; and of the
# first swin_wgrad_f32 launch: a few per SM at the card's 132 (fixed
# numbers, so that every sum's order depends on the shapes alone)
F32_MLP_BWD_ROWS = 528
F32_ATTN_BWD_BLOCKS = 1056
F32_WGRAD_BLOCKS = 264
F32_BWD_THREADS = 128  # a core block of swin_attn_bwd_f32 (BTHREADS)
F32_WGRAD_TILE = 96  # swin_wgrad_f32's output tile side (WT)
F32_WGRAD_K = 16  # its tokens a step (WK)
F32_WGRAD_THREADS = 192  # WTHREADS


def _runs(total: int, grid: int) -> List[Tuple[int, Tuple[int, int]]]:
    """(block, [first, last)) of each of `grid` blocks over `total` units,
    block q taking [total q / G, total (q + 1) / G), as the kernels split."""
    return [(q, (total * q // grid, total * (q + 1) // grid)) for q in range(grid)]


def ln_bwd_smem_bytes(C: int) -> int:
    """The row pass's shared bytes: each warp's three column sums of C."""
    return 4 * F32_ROW_WARPS * 3 * C


@dataclasses.dataclass(frozen=True)
class MlpBwdF32Plan:
    n_tokens: int
    C: int
    hidden: int
    grid: int  # row-pass blocks, one partial row each
    fc1: GemmF32Plan  # LN2(h1) W1^T + b1 -> GELU(a1) and a1
    dg: GemmF32Plan  # (k dy) W2 times GELU'(a1) -> da1
    dm: GemmF32Plan  # da1 W1 -> the dm workspace

    @property
    def part_rows(self) -> int:
        return self.grid

    @property
    def part_cols(self) -> int:
        """[db1 (hidden) | db2 | dLN2 w | dLN2 b (C each)]."""
        return self.hidden + 3 * self.C

    @property
    def row_smem_bytes(self) -> int:
        return ln_bwd_smem_bytes(self.C)

    def rp_blocks(self) -> List[Tuple[int, Tuple[int, int]]]:
        """(block, [first, last) token) of each row-pass block."""
        return _runs(self.n_tokens, self.grid)


def mlp_bwd_f32_plan(n_tokens: int, C: int, hidden: int) -> MlpBwdF32Plan:
    """The swin_mlp_bwd_f32 launches for n_tokens rows of width C (96-384
    for the swin blocks, 384 and 768 for the ViT blocks' vit_mlp_bwd_f32); a
    ValueError for a geometry the kernels do not take."""
    if C not in WIDTHS or hidden <= 0 or hidden % F32_TILE_COLS:
        raise ValueError(f"the float32 MLP backward takes C in {WIDTHS} and a hidden width "
                         f"in 96s, got C {C}, hidden {hidden}")
    return MlpBwdF32Plan(n_tokens, C, hidden, min(F32_MLP_BWD_ROWS, n_tokens // F32_TILE_ROWS),
                         _gemm_f32(n_tokens, hidden, C), _gemm_f32(n_tokens, hidden, C),
                         _gemm_f32(n_tokens, C, hidden))


@dataclasses.dataclass(frozen=True)
class AttnBwdF32Plan:
    B: int
    H: int
    W: int
    C: int
    heads: int
    grid: int  # the core's window runs (a block a run and head), and the row pass's blocks
    qkv: GemmF32Plan  # LN1(x) W_qkv^T + b_qkv -> the dqkv rows
    do: GemmF32Plan  # (k1 dh1) W_proj -> the workspace
    dh: GemmF32Plan  # dqkv W_qkv -> the workspace

    @property
    def windows(self) -> int:
        return self.B * (self.H // 8) * (self.W // 8)

    @property
    def n_tokens(self) -> int:
        return 64 * self.windows

    @property
    def core_grid(self) -> Tuple[int, int]:
        return self.grid, self.heads

    @property
    def core_smem_bytes(self) -> int:
        # q^T and do^T (rows padded by 4), k^T and v^T, q, k, v and do
        # row-major, P and dS (rows padded by 1), the dq | dk | dv tile
        hd = F32_HD
        return 4 * (2 * hd * 68 + 2 * hd * 64 + 4 * 64 * hd + 2 * 64 * 65 + 64 * (3 * hd + 1))

    @property
    def row_smem_bytes(self) -> int:
        return ln_bwd_smem_bytes(self.C)

    @property
    def part_rows(self) -> int:
        return self.grid

    @property
    def part_cols(self) -> int:
        """[dbias (heads 64 64) | db_qkv (3 heads 32) | db_proj | dLN1 w | dLN1 b]."""
        return self.heads * 64 * 64 + 3 * self.heads * HDP + 3 * self.C

    def blocks(self) -> List[Tuple[int, Tuple[int, int]]]:
        """(block, [first, last) window) of each core run (every head)."""
        return _runs(self.windows, self.grid)

    def rp_blocks(self) -> List[Tuple[int, Tuple[int, int]]]:
        return _runs(self.n_tokens, self.grid)


def attn_bwd_f32_plan(B: int, H: int, W: int, C: int, heads: int) -> AttnBwdF32Plan:
    """The swin_attn_bwd_f32 launches for x (B, H, W, C) with `heads`
    heads; a ValueError for a geometry the kernels do not take."""
    if C not in WIDTHS[:3] or B <= 0 or H <= 0 or W <= 0 or H % 8 or W % 8:
        raise ValueError(f"the float32 attention backward takes C in {WIDTHS[:3]} and H, W "
                         f"multiples of 8, got {(B, H, W, C)}")
    if heads * F32_HD != C:
        raise ValueError(f"the float32 attention backward takes a head dim of {F32_HD}, got C "
                         f"{C} with {heads} heads")
    windows = B * (H // 8) * (W // 8)
    n, Cp3 = 64 * windows, 3 * heads * HDP
    grid = min(windows, _cdiv(F32_ATTN_BWD_BLOCKS, heads))
    return AttnBwdF32Plan(B, H, W, C, heads, grid, _gemm_f32(n, Cp3, C), _gemm_f32(n, C, C),
                          _gemm_f32(n, C, Cp3))


@dataclasses.dataclass(frozen=True)
class WgradF32Plan:
    n: int
    M: int
    N: int
    chunk: int  # tokens a chunk, a multiple of 64

    @property
    def S(self) -> int:
        return _cdiv(self.n, self.chunk)

    @property
    def tiles(self) -> int:
        return (self.M // F32_WGRAD_TILE) * (self.N // F32_WGRAD_TILE)

    @property
    def ws_floats(self) -> int:
        """The chunks' partial products, when there is more than one."""
        return self.S * self.M * self.N if self.S > 1 else 0

    def chunks(self) -> List[Tuple[int, int]]:
        return [(s * self.chunk, min(self.n, (s + 1) * self.chunk)) for s in range(self.S)]


@functools.lru_cache(maxsize=256)
def wgrad_f32_plan(n: int, M: int, N: int) -> WgradF32Plan:
    """swin_wgrad_f32's split of an (n, M) x (n, N) product over token
    chunks, fixed by the shapes alone: about F32_WGRAD_BLOCKS (tile, chunk)
    blocks, each chunk a multiple of 64 tokens; a ValueError for a shape
    the kernel does not take."""
    if n <= 0 or n % 64 or M <= 0 or M % F32_WGRAD_TILE or N <= 0 or N % F32_WGRAD_TILE:
        raise ValueError(f"the float32 weight product takes n in 64s and widths in 96s, got "
                         f"({n}, {M}) x ({n}, {N})")
    tiles = (M // F32_WGRAD_TILE) * (N // F32_WGRAD_TILE)
    steps = n // 64
    S = max(1, min(steps, F32_WGRAD_BLOCKS // tiles))
    return WgradF32Plan(n, M, N, _cdiv(steps, S) * 64)
