"""Launch plans of csrc/vit_rows.cu, HeAR's ViT-L (C = 1024) qkv and MLP
halves as a LayerNorm row pass and token-row GEMMs, computed on the host
(the ops/swin_plan.py sibling for that width). ops/vit.py passes a plan's
numbers to the launch; tests/test_torch_vit_plan.py enumerates the plans
at HeAR's token counts. Nothing here touches a card.

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

from .swin_plan import SMEM_LIMIT

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
