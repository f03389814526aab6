"""Launch plans of csrc/vit_rows.cu, HeAR's ViT-L (C = 1024) qkv and MLP
halves as a LayerNorm row pass and token-row GEMMs, and of the float32 ViT
kernels (csrc/vit_f32.cu, csrc/vit_attn_bwd_f32.cu, and csrc/swin_mlp_f32.cu
/ swin_mlp_bwd_f32.cu as the MLP half; below), computed on the host (the
ops/swin_plan.py sibling for these). ops/vit.py and ops/vit_train.py pass a
plan's numbers to the launch; tests/test_torch_vit_plan.py and
tests/test_torch_vit_train_f32.py enumerate the plans at the towers' token
counts. Nothing here touches a card.

    vit_qkv  row pass LN1 -> h;  GEMM h W_qkv^T (+ b_qkv, head-major)
    vit_mlp  row pass LN2 -> h;  GEMM h W1^T (+ b1, GELU) -> g;
             GEMM g W2^T (+ b2, + x)

A GEMM runs persistent blocks, at most one an SM, over 128 x 128 output
tiles (all of K each, on the wgmma pieces of csrc/wgmma_gemm.cuh): block b
of a grid of G takes tiles b, b + G, ..., tile t at column tile
t % (N / 128) and row tile t // (N / 128); its producer warp streams the A
and B boxes of all of them through one ring of four 32 KB stages. The two
consumer warpgroups take the block's tiles in turns (ping-pong), or, where
no block has a second tile, share each tile (cooperative). No cluster and
no split-K, so every output element is one block's sum in one order.

tiled_mlp and tiled_qkv are float32 torch models of the kernels' order:
each tile summed over K in the ring's 64-column steps, then its epilogue,
tile by tile and block by block from the plan.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import torch
import torch.nn.functional as F

from .swin_plan import (F32_MLP_BWD_ROWS, F32_TILE_COLS, F32_TILE_K, F32_TILE_ROWS, SMEM_LIMIT,
                        GemmF32Plan, MlpF32Plan, ln_bwd_smem_bytes)

ROWS_WIDTHS = (1024,)  # the widths csrc/vit_rows.cu serves (HeAR's ViT-L)
GEMM_COLS = 128  # output columns of a tile (csrc/wgmma_gemm.cuh)
GEMM_BK = 64  # K of a ring stage
TILE_ROWS = 128  # token rows of a tile
STAGES = 4  # ring stages (csrc/vit_rows.cu RG_STAGES)
STAGE_BYTES = 4 * 64 * 64 * 2  # A's two 64 x 64 bf16 boxes, then B's two
OUT_LD = GEMM_COLS + 8  # bf16 row of the staged tile
LN_WARPS = 8  # rows a row-pass block (one warp a row)
HD = 64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    M: int  # token rows
    N: int  # output columns
    K: int
    grid: int  # persistent blocks

    @property
    def tiles_n(self) -> int:
        return self.N // GEMM_COLS

    @property
    def tiles(self) -> int:
        return self.tiles_n * _cdiv(self.M, TILE_ROWS)

    @property
    def smem_bytes(self) -> int:
        """sizeof(RowsGemmSmem) (the ring, each warpgroup's staged bf16
        tile, two barriers a stage) and the 1024-byte alignment slack."""
        return STAGES * STAGE_BYTES + 2 * TILE_ROWS * OUT_LD * 2 + 16 * STAGES + 1024

    @property
    def cooperative(self) -> bool:
        """Both warpgroups on every tile (no block has a second tile), else
        ping-pong (the kernel's own test: tiles <= grid)."""
        return self.tiles <= self.grid

    @property
    def k_steps(self) -> int:
        return self.K // GEMM_BK

    @property
    def operations(self) -> int:
        """Multiply-adds counted as two: 2 M N K, each product once."""
        return 2 * self.M * self.N * self.K

    def tile(self, t: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        """(token rows, output columns) of tile t; rows past M are not
        stored."""
        r0, c0 = (t // self.tiles_n) * TILE_ROWS, (t % self.tiles_n) * GEMM_COLS
        return (r0, min(r0 + TILE_ROWS, self.M)), (c0, c0 + GEMM_COLS)

    def blocks(self) -> List[Tuple[int, List[int]]]:
        """(block, its tiles in order) by the kernel's index arithmetic."""
        return [(b, list(range(b, self.tiles, self.grid))) for b in range(self.grid)]


def gemm_plan(M: int, N: int, K: int, sms: int) -> GemmPlan:
    if M <= 0 or N <= 0 or N % GEMM_COLS or K <= 0 or K % GEMM_BK or sms <= 0:
        raise ValueError(f"the GEMM takes N a multiple of {GEMM_COLS} and K of {GEMM_BK}, got "
                         f"M {M}, N {N}, K {K}")
    return GemmPlan(M, N, K, min(sms, (N // GEMM_COLS) * _cdiv(M, TILE_ROWS)))


@dataclasses.dataclass(frozen=True)
class RowsQkvPlan:
    n_tokens: int
    C: int
    qkv: GemmPlan

    @property
    def operations(self) -> int:
        return self.qkv.operations


@dataclasses.dataclass(frozen=True)
class RowsMlpPlan:
    n_tokens: int
    C: int
    hidden: int
    fc1: GemmPlan
    fc2: GemmPlan

    @property
    def operations(self) -> int:
        """fc1 and fc2, each once a token: 4 C hidden (16 C^2 at hidden 4 C)."""
        return self.fc1.operations + self.fc2.operations


def _check(n_tokens: int, C: int, sms: int):
    if C not in ROWS_WIDTHS or n_tokens <= 0 or sms <= 0:
        raise ValueError(f"csrc/vit_rows.cu takes C in {ROWS_WIDTHS} and n_tokens > 0, got C {C}, "
                         f"n_tokens {n_tokens}")


@functools.lru_cache(maxsize=256)
def qkv_plan(n_tokens: int, C: int, sms: int) -> RowsQkvPlan:
    """vit_qkv's launch at C = 1024 for n_tokens rows on a card of `sms` SMs."""
    _check(n_tokens, C, sms)
    return RowsQkvPlan(n_tokens, C, gemm_plan(n_tokens, 3 * C, C, sms))


@functools.lru_cache(maxsize=256)
def mlp_plan(n_tokens: int, C: int, hidden: int, sms: int) -> RowsMlpPlan:
    """vit_mlp's launch at C = 1024 for n_tokens rows on a card of `sms` SMs."""
    _check(n_tokens, C, sms)
    if hidden <= 0 or hidden % GEMM_COLS:
        raise ValueError(f"csrc/vit_rows.cu takes hidden a multiple of {GEMM_COLS}, got {hidden}")
    return RowsMlpPlan(n_tokens, C, hidden, gemm_plan(n_tokens, hidden, C, sms),
                       gemm_plan(n_tokens, C, hidden, sms))


# ---------------------------------------------------------------------------
# float32 models of the kernels' order
# ---------------------------------------------------------------------------


def _step_sum(a: torch.Tensor, w: torch.Tensor, k_steps: int) -> torch.Tensor:
    """A W^T in float32, summed over the ring's 64-column K steps in order:
    each element's sum order is that of the tile owning it."""
    acc = torch.zeros(a.shape[0], w.shape[0], dtype=torch.float32)
    for s in range(k_steps):
        k = slice(GEMM_BK * s, GEMM_BK * (s + 1))
        acc += a[:, k].float() @ w[:, k].float().T
    return acc


def _gemm_model(plan: GemmPlan, a, w, epilogue) -> torch.Tensor:
    """The GEMM tile by tile, block by block; every output element written
    exactly once (an element left unwritten stays NaN, one written twice
    raises)."""
    acc = _step_sum(a, w, plan.k_steps)
    out = torch.full((plan.M, plan.N), float("nan"))
    for _, tiles in plan.blocks():
        for t in tiles:
            (r0, r1), (c0, c1) = plan.tile(t)
            if not torch.isnan(out[r0:r1, c0:c1]).all():
                raise AssertionError(f"tile rows {(r0, r1)} cols {(c0, c1)} overlaps another")
            out[r0:r1, c0:c1] = epilogue(acc[r0:r1, c0:c1], (r0, r1), (c0, c1))
    return out


def _ln_rows(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * w + b).to(torch.bfloat16)


def tiled_mlp(x: torch.Tensor, p, plan: RowsMlpPlan, eps: float = 1e-6) -> torch.Tensor:
    """The MLP half in the kernels' order and rounding points: x (n, C)
    bf16, p a VitBlockParams in bf16; returns (n, C) bf16."""
    h = _ln_rows(x, p.ln2_w, p.ln2_b, eps)
    g = _gemm_model(plan.fc1, h, p.w_fc1, lambda acc, r, c: F.gelu(
        acc + p.b_fc1[c[0]:c[1]].float(), approximate="none")).to(torch.bfloat16)

    def resid(acc, r, c):
        return x[r[0]:r[1], c[0]:c[1]].float() + (acc + p.b_fc2[c[0]:c[1]].float())
    return _gemm_model(plan.fc2, g, p.w_fc2, resid).to(torch.bfloat16)


def tiled_qkv(x: torch.Tensor, p, plan: RowsQkvPlan, Np: int,
              eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """vit_qkv in the kernels' order: x (n, C) bf16 -> (qkv (3, B, heads,
    Np, 64), LN1 rows (n, C)), bf16."""
    h = _ln_rows(x, p.ln1_w, p.ln1_b, eps)
    flat = _gemm_model(plan.qkv, h, p.w_qkv,
                       lambda acc, r, c: acc + p.b_qkv[c[0]:c[1]].float()).to(torch.bfloat16)
    n, C = x.shape
    heads = C // HD
    return flat.reshape(n // Np, Np, 3, heads, HD).permute(2, 0, 3, 1, 4).contiguous(), h


# ---------------------------------------------------------------------------
# the float32 kernels (the TPU bodies at mm_dtype=float32): fixed tiles, a
# product block a (64 token rows, 96 columns) tile, an attention block a
# (tile of 64 query rows or keys, head, clip); the row pass over a fixed
# number of contiguous token runs, so every sum's order depends on the
# shapes alone
# ---------------------------------------------------------------------------

F32_WIDTHS = (384, 768)  # ViT-S (operaGT) and ViT-B (Audio-MAE); HeAR's 1024 has no float32 route
F32_ATTN_TILE = 64  # query rows or keys of an attention tile (csrc/vit_f32_attn.cuh AT)
F32_ATTN_THREADS = 128  # an attention block (ATHREADS)
F32_ROW_STRIDE = F32_ATTN_TILE + 4  # a row tile's stride in floats (RS)
F32_COL_STRIDE = F32_ATTN_TILE + 1  # a column tile's (CS)
F32_TOKEN_TILE = 64  # B Np of the backward: the weight products' 64-token steps


def _check_f32(n_tokens: int, C: int):
    if C not in F32_WIDTHS or n_tokens <= 0 or n_tokens % 16:
        raise ValueError(f"the float32 ViT kernels take C in {F32_WIDTHS} and B Np a multiple of "
                         f"16, got C {C}, {n_tokens} tokens")


def _rows_f32(M: int, N: int, K: int) -> GemmF32Plan:
    """The float32 token-row product over M rows (a multiple of 16: the last
    row tile is partial)."""
    if M <= 0 or M % 16 or N <= 0 or N % F32_TILE_COLS or K <= 0 or K % F32_TILE_K:
        raise ValueError(f"the float32 product takes rows in 16s, columns in 96s and a depth in "
                         f"16s, got ({M}, {N}, {K})")
    return GemmF32Plan(M, N, K)


def qkv_f32_plan(n_tokens: int, C: int) -> GemmF32Plan:
    """vit_qkv_f32's launch: LN1(x) W_qkv^T + b_qkv over n_tokens rows."""
    _check_f32(n_tokens, C)
    return _rows_f32(n_tokens, 3 * C, C)


def proj_f32_plan(n_tokens: int, C: int) -> GemmF32Plan:
    """vit_proj_f32's launch: o_pre W_proj^T + b_proj + x."""
    _check_f32(n_tokens, C)
    return _rows_f32(n_tokens, C, C)


def mlp_f32_plan(n_tokens: int, C: int, hidden: int) -> MlpF32Plan:
    """vit_mlp_f32's two launches of csrc/swin_mlp_f32.cu (fc1 + GELU into
    the workspace, fc2 + x)."""
    _check_f32(n_tokens, C)
    return MlpF32Plan(n_tokens, C, hidden, _rows_f32(n_tokens, hidden, C),
                      _rows_f32(n_tokens, C, hidden))


def _check_attn(B: int, Np: int, C: int, heads: int):
    if C not in F32_WIDTHS or heads * HD != C:
        raise ValueError(f"the float32 attention kernels take C in {F32_WIDTHS} with head dim "
                         f"{HD}, got C {C} with {heads} heads")
    if B <= 0 or B > 65535 or Np <= 0 or Np % 16:
        raise ValueError(f"the float32 attention kernels take tokens padded to a multiple of 16 "
                         f"and 1 <= B <= 65535, got B {B}, Np {Np}")


def _tiles(Np: int) -> List[Tuple[int, int]]:
    """[first, last) rows of each attention tile over Np tokens."""
    return [(i, min(Np, i + F32_ATTN_TILE)) for i in range(0, Np, F32_ATTN_TILE)]


def _attn_tile_bytes(row_tiles: int, col_tiles: int, extra: int = 0) -> int:
    return 4 * (F32_ATTN_TILE * (row_tiles * F32_ROW_STRIDE + col_tiles * F32_COL_STRIDE) + extra)


@dataclasses.dataclass(frozen=True)
class AttnF32Plan:
    B: int
    Np: int
    C: int
    heads: int

    @property
    def grid(self) -> Tuple[int, int, int]:
        """(query tiles, heads, clips): a core block a (tile, head, clip)."""
        return _cdiv(self.Np, F32_ATTN_TILE), self.heads, self.B

    @property
    def smem_bytes(self) -> int:
        """The q tile and P^T (row tiles), the k and v tiles (column tiles)."""
        return _attn_tile_bytes(2, 2)

    def tiles(self) -> List[Tuple[int, int]]:
        """[first, last) query rows of each tile of a (clip, head)."""
        return _tiles(self.Np)


@functools.lru_cache(maxsize=256)
def attn_f32_plan(B: int, Np: int, C: int, heads: int) -> AttnF32Plan:
    """vit_attn_f32's launch for qkv of B clips of Np tokens; a ValueError
    for a geometry the kernel does not take."""
    _check_attn(B, Np, C, heads)
    return AttnF32Plan(B, Np, C, heads)


@dataclasses.dataclass(frozen=True)
class AttnBwdF32Plan:
    B: int
    Np: int
    C: int
    heads: int
    grid: int  # the row pass's blocks, one partial row each
    qkv: GemmF32Plan  # LN1(x) W_qkv^T + b_qkv -> the qkv workspace
    do: GemmF32Plan  # dh1 W_proj -> the do workspace
    dh: GemmF32Plan  # dqkv W_qkv -> the dh workspace

    @property
    def n_tokens(self) -> int:
        return self.B * self.Np

    @property
    def attn_grid(self) -> Tuple[int, int, int]:
        """(tiles, heads, clips) of the query pass (query tiles) and of the
        key pass (key tiles)."""
        return _cdiv(self.Np, F32_ATTN_TILE), self.heads, self.B

    @property
    def query_smem_bytes(self) -> int:
        """q^T, do^T, P^T, dS^T (row tiles), k^T, v^T (column tiles)."""
        return _attn_tile_bytes(4, 2)

    @property
    def key_smem_bytes(self) -> int:
        """k^T, v^T, P, dS (row tiles), q^T, do^T (column tiles), and the
        query tile's (m, 1 / l, D)."""
        return _attn_tile_bytes(4, 2, 3 * F32_ATTN_TILE)

    @property
    def row_smem_bytes(self) -> int:
        return ln_bwd_smem_bytes(self.C)

    @property
    def part_rows(self) -> int:
        return self.grid

    @property
    def part_cols(self) -> int:
        """[db_qkv (3C) | db_proj | dLN1 w | dLN1 b (C each)]."""
        return 6 * self.C

    @property
    def stats_shape(self) -> Tuple[int, int]:
        """(m, 1 / l, D) of every query row of every (clip, head)."""
        return 3, self.B * self.heads * self.Np

    def tiles(self) -> List[Tuple[int, int]]:
        return _tiles(self.Np)

    def rp_blocks(self) -> List[Tuple[int, Tuple[int, int]]]:
        """(block, [first, last) token) of each row-pass block."""
        n, G = self.n_tokens, self.grid
        return [(q, (n * q // G, n * (q + 1) // G)) for q in range(G)]


@functools.lru_cache(maxsize=256)
def attn_bwd_f32_plan(B: int, Np: int, C: int, heads: int) -> AttnBwdF32Plan:
    """vit_attn_bwd_f32's launches for B clips of Np tokens (B Np a multiple
    of F32_TOKEN_TILE); a ValueError for a geometry the kernels do not take."""
    _check_attn(B, Np, C, heads)
    n = B * Np
    if n % F32_TOKEN_TILE:
        raise ValueError(f"the float32 ViT backward takes B Np a multiple of {F32_TOKEN_TILE}, "
                         f"got B {B}, Np {Np}")
    grid = min(F32_MLP_BWD_ROWS, n // F32_TILE_ROWS)
    return AttnBwdF32Plan(B, Np, C, heads, grid, _rows_f32(n, 3 * C, C), _rows_f32(n, C, C),
                          _rows_f32(n, C, 3 * C))
