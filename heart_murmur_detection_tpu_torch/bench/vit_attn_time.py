"""Times of the attention half after vit_qkv (the vit_attn core and the
vit_proj launch) at the MAE towers' shapes, both softmax modes.

    python -m heart_murmur_detection_tpu_torch.bench.vit_attn_time [tag]

For operaGT (C 384, 6 heads, 1040 tokens, 1025 real) at B=16 and 64 and
Audio-MAE (C 768, 12 heads, 528 tokens, 513 real) at B=16 and 32, one
random block (seed 0) and random tokens: the cosine of the branch
(out - x) against the plain attention half, the CUDA-event time of the
half (3 warm-up runs, mean of 20) and of each launch alone, and SDPA's time
on the same q, k, v (keys sliced to n_real). Prints one line a shape,
prefixed by `tag`; run it once per source tree to compare two versions on
one card (a tree whose vit_attn still fuses proj, before vit_proj existed,
is timed as one launch). Needs a card.
"""

from __future__ import annotations

import sys

import torch

from ..ops import vit

SHAPES = ((384, 6, 1040, 1025, 16), (384, 6, 1040, 1025, 64),
          (768, 12, 528, 513, 16), (768, 12, 528, 513, 32))


def _ms(fn, iters: int = 20, warm: int = 3) -> float:
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


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tag = argv[0] if argv else "vit_attn"
    if not torch.cuda.is_available():
        print("vit_attn_time: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version is an f32 reference
    for C, heads, Np, n_real, B in SHAPES:
        g = torch.Generator().manual_seed(0)
        f = lambda *s: torch.randn(*s, generator=g) * 0.05
        sd = {"norm1.weight": 1 + f(C), "norm1.bias": f(C), "attn.qkv.weight": f(3 * C, C) * 2,
              "attn.qkv.bias": f(3 * C), "attn.proj.weight": f(C, C), "attn.proj.bias": f(C),
              "norm2.weight": 1 + f(C), "norm2.bias": f(C), "mlp.fc1.weight": f(4 * C, C),
              "mlp.fc1.bias": f(4 * C), "mlp.fc2.weight": f(C, 4 * C), "mlp.fc2.bias": f(C)}
        p = vit.prep_vit_block(sd, heads, torch.bfloat16, "cuda")
        x = (torch.randn(B, Np, C, generator=g) * 0.5).to("cuda", torch.bfloat16)
        qkv = vit.vit_qkv(x, p)
        split = hasattr(vit, "vit_proj")
        out = {}
        for mode in ("stable", "fast"):
            if split:
                half = lambda: vit.vit_proj(vit.vit_attn(qkv, p, n_real, mode), x, p)
            else:
                half = lambda: vit.vit_attn(x, qkv, p, n_real, mode)
            got = half()
            want = vit.vit_attn_out_ref(x, qkv, p, n_real, mode)
            a = (got.double() - x.double()).flatten()
            b = (want.double() - x.double()).flatten()
            out[f"cos_{mode}"] = round(float(a @ b / (a.norm() * b.norm())), 8)
            out[f"ms_{mode}"] = round(_ms(half), 4)
            if split:
                o = vit.vit_attn(qkv, p, n_real, mode)
                out[f"ms_core_{mode}"] = round(_ms(lambda: vit.vit_attn(qkv, p, n_real, mode)), 4)
                out[f"ms_proj_{mode}"] = round(_ms(lambda: vit.vit_proj(o, x, p)), 4)
        q, k, v = qkv[0], qkv[1][:, :, :n_real], qkv[2][:, :, :n_real]
        out["ms_sdpa"] = round(_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=1.0)), 4)
        print(tag, f"C={C} B={B}", out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
