"""Launch plans of the two forward wgmma kernels, computed on the host in one
place: csrc/swin_mlp.cu (swin_mlp, and vit_mlp with LN eps 1e-6) and
csrc/swin_attn.cu (swin_attn). The wrappers in ops/swin.py and ops/vit.py
pass a plan's numbers to the launch, which checks them against the kernel's
compiled configuration; the CPU tests (tests/test_torch_swin_plan.py)
enumerate the plans of every geometry the towers launch.

swin_mlp: a block owns a panel of token rows (128 at C <= 192, where each
warpgroup holds 64 rows and every output column; 64 at C >= 384, where the
two warpgroups split the block's output columns), the block's output columns
(all of C, or half of it at C = 768: two blocks a panel, each recomputing
fc1), and a share of the hidden chunks: a cluster of `ks` blocks over the
hidden dimension, whose fc2 sums are added in rank order.

swin_attn: a block owns two windows at C <= 192 (a warpgroup a window) or
one at C >= 384 (the warpgroups take two heads at a time), and a share of
the window's heads: a cluster of `cs` blocks, each of which then computes
proj for C / cs output columns.

The cluster sizes come from the grid and the SM count: the fewest waves,
counting a block of a k-block cluster as 1 / k of the work plus what the
split adds (the partial sums or the gathered head outputs, the repeated
LayerNorm), as vit_qkv.cu splits its columns. Nothing here touches a card.
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
WIDTHS = (96, 192, 384, 768)

MLP_STAGE = 16384  # bytes of a ring stage (csrc/swin_mlp.cu)
W2_ROWS = 96  # output rows of a W2 box
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
    if C not in WIDTHS or n_tokens <= 0 or sms <= 0:
        raise ValueError(f"the MLP kernel takes C in {WIDTHS} and n_tokens > 0, got C {C}, "
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
    nb = min(C, 384)
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
