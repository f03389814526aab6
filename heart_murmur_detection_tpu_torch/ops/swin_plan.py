"""Launch plans of the wgmma kernels of the swin and ViT blocks, computed on
the host in one place: the forward kernels csrc/swin_mlp.cu (swin_mlp, and
vit_mlp with LN eps 1e-6) and csrc/swin_attn.cu (swin_attn), and the
backward kernels csrc/swin_mlp_bwd.cu (swin_mlp_bwd and vit_mlp_bwd) and
csrc/swin_attn_bwd.cu (swin_attn_bwd). The wrappers in ops/swin.py,
ops/vit.py, ops/swin_train.py and ops/vit_train.py pass a plan's numbers to
the launch, which checks them against the kernel's compiled configuration;
the CPU tests (tests/test_torch_swin_plan.py, tests/test_torch_bwd_plan.py)
enumerate the plans of every geometry the towers launch.

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
last 3 C columns. Nothing here touches a card.
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
