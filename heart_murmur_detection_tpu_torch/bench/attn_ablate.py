"""The attention-half chains of the TPU kernels K10 (bench/gt_attn_opt.py)
and K11 (bench/vit_attn_ablate.py) on the port's vit_qkv + vit_attn +
vit_proj kernels, every mode name of both files.

    python -m heart_murmur_detection_tpu_torch.bench.attn_ablate [depth]

At the operaGT shape, B=64 clips of 1040 tokens (all keys real), C 384, 6
heads of 64: the weights of each mode drawn as the files draw them, from
np.random.default_rng(0) after the input x, in the files' order (w_qkv,
b_qkv, w_proj, b_proj times 0.02; LN1 ones and zeros; q unscaled), the half
chained `depth` (8) times. Each mode name runs as the port's mode of
JAX_MODES. One JSON line a mode name: the cosine of one half's
branch (out - x) against its plain version, the chain's CUDA-event time on
the kernels, on the plain versions, and in the production stable softmax
with the same weights, one vit_attn (attention core) and one vit_proj
launch alone, and
torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=1.0) on the
same q, k, v (the library time of the softmax modes' attention core; no
call computes the others). aligned_hcat prints the ValueError that defines
it at this shape, as the TPU harness prints FAIL. Reads nothing of the
root bench/ files; needs a card.
"""

from __future__ import annotations

import json
import sys
from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops import vit

B, NP, C, HEADS = 64, 1040, 384, 6
DEPTH = 8
FILES = {
    "gt_attn_opt": ("v0", "v1", "v2", "v3", "v4", "v5", "noattn"),
    "vit_attn_ablate": ("full", "no_softmax", "no_attn", "aligned_hcat", "ident"),
}
# every mode name of both files -> the port's vit_attn mode (ops/vit.py)
JAX_MODES = {
    ("gt_attn_opt", "v0"): "norm_before", ("gt_attn_opt", "v1"): "norm_before",
    ("gt_attn_opt", "v2"): "norm_before", ("gt_attn_opt", "v3"): "fast",
    ("gt_attn_opt", "v4"): "fast", ("gt_attn_opt", "v5"): "bf16_exp",
    ("gt_attn_opt", "noattn"): "q_passthrough",
    ("vit_attn_ablate", "full"): "norm_before", ("vit_attn_ablate", "no_softmax"): "no_softmax",
    ("vit_attn_ablate", "no_attn"): "q_passthrough",
    ("vit_attn_ablate", "aligned_hcat"): "aligned_hcat",
    ("vit_attn_ablate", "ident"): "q_passthrough",
}
SOFTMAX_MODES = ("stable", "fast", "norm_before", "bf16_exp")


def draw_weights(rng: np.random.Generator, C: int) -> Tuple[np.ndarray, ...]:
    """One mode's weights as the files' build() draws them: (w_qkv (C, 3C),
    b_qkv (1, 3C), w_proj (C, C), b_proj (1, C), ln1 scale, ln1 bias), float32
    (the files round both matmul weights to bf16, as the layout does)."""
    g = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.02
    w_qkv, b_qkv, w_proj, b_proj = g(C, 3 * C), g(1, 3 * C), g(C, C), g(1, C)
    return w_qkv, b_qkv, w_proj, b_proj, np.ones((1, C), np.float32), np.zeros((1, C), np.float32)


def half_params(w: Sequence[np.ndarray], heads: int, device=None) -> vit.VitBlockParams:
    """The attention-half weights (draw_weights's flax layout) as a bf16
    kernel layout with q unscaled; the MLP half (unused) is zeros."""
    w_qkv, b_qkv, w_proj, b_proj, ln_s, ln_b = (torch.from_numpy(np.asarray(a, np.float32))
                                                for a in w)
    Cw = w_qkv.shape[0]
    sd = {"norm1.weight": ln_s[0], "norm1.bias": ln_b[0], "attn.qkv.weight": w_qkv.T,
          "attn.qkv.bias": b_qkv[0], "attn.proj.weight": w_proj.T, "attn.proj.bias": b_proj[0],
          "norm2.weight": torch.ones(Cw), "norm2.bias": torch.zeros(Cw),
          "mlp.fc1.weight": torch.zeros(4 * Cw, Cw), "mlp.fc1.bias": torch.zeros(4 * Cw),
          "mlp.fc2.weight": torch.zeros(Cw, 4 * Cw), "mlp.fc2.bias": torch.zeros(Cw)}
    get = lambda k: sd[k].to(device=device, dtype=torch.float32)
    return vit.vit_block_layout(get, heads, torch.bfloat16, qk_scale=1.0)


def chain(x: torch.Tensor, p: vit.VitBlockParams, mode: str, depth: int = DEPTH,
          impl: str = "kernel") -> torch.Tensor:
    """`depth` attention halves in `mode`, each on the last one's output."""
    for _ in range(depth):
        x = vit.fused_vit_attn(x, p, impl=impl, mode=mode)
    return x


def _ms(fn, iters: int = 10, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def branch_cos(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor) -> float:
    a = (got.double() - x.double()).flatten()
    b = (want.double() - x.double()).flatten()
    return float(a @ b / (a.norm() * b.norm()))


def measure(file: str, name: str, x: torch.Tensor, w, depth: int = DEPTH) -> dict:
    """One mode name of one file on the card: see the module doc."""
    mode = JAX_MODES[(file, name)]
    p = half_params(w, HEADS, x.device)
    row = {"file": file, "mode": name, "port_mode": mode, "B": x.shape[0], "Np": x.shape[1],
           "C": x.shape[2], "heads": HEADS, "depth": depth}
    try:
        chain(x, p, mode, 1)
    except ValueError as e:
        row["result"] = f"ValueError: {e}"
        return row
    qkv = vit.vit_qkv(x, p)
    half = lambda: vit.vit_proj(vit.vit_attn(qkv, p, mode=mode), x, p)
    got = half()
    want = vit.vit_attn_out_ref(x, qkv, p, mode=mode)
    row["branch_cos"] = branch_cos(got, want, x)
    row["bitwise_repeat"] = bool(torch.equal(got, half()))
    row["chain_ms"] = _ms(lambda: chain(x, p, mode, depth))
    row["stable_chain_ms"] = _ms(lambda: chain(x, p, "stable", depth))
    row["plain_chain_ms"] = _ms(lambda: chain(x, p, mode, depth, "plain"), iters=2, warm=1)
    o = vit.vit_attn(qkv, p, mode=mode)
    row["vit_attn_ms"] = _ms(lambda: vit.vit_attn(qkv, p, mode=mode))
    row["vit_proj_ms"] = _ms(lambda: vit.vit_proj(o, x, p))
    row["vit_attn_plain_ms"] = _ms(lambda: vit.vit_attn_out_ref(x, qkv, p, mode=mode), iters=3,
                                   warm=1)
    if mode in SOFTMAX_MODES:
        q, k, v = qkv[0], qkv[1], qkv[2]
        row["sdpa_ms"] = _ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=1.0))
    return row


def inputs(device) -> Tuple[torch.Tensor, np.random.Generator]:
    """x (B, Np, C) bf16 and the generator after it, as each file draws them."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B, NP, C)).astype(np.float32))
    return x.to(device, torch.bfloat16), rng


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    depth = int(argv[0]) if argv else DEPTH
    if not torch.cuda.is_available():
        print("attn_ablate: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions are f32 references
    for file, names in FILES.items():
        x, rng = inputs("cuda")
        for name in names:
            print(json.dumps(measure(file, name, x, draw_weights(rng, C), depth)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
