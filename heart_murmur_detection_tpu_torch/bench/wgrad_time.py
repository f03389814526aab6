"""Times of swin_wgrad, the weight-gradient product dW = A^T B, at the
shapes of one COLA step and one Audio-MAE step, against torch.mm.

    python -m heart_murmur_detection_tpu_torch.bench.wgrad_time [tag]

The products of a COLA continued-pretraining step of operaCT at B=64 (the
four weight products of each train block of HTS-AT stages 0-2: 2, 2 and 6
blocks at each of the two shifts) and of an Audio-MAE step at B=64 (160
tokens a clip, 12 blocks), on random bf16 operands (seed 0): for each shape
the cosine against the float32 product, whether two launches agree bitwise,
and the CUDA-event time a launch of swin_wgrad (the whole product, every
launch it takes) and of torch.mm(a.t(), b); then the step sums, each shape
weighted by its launches a step. Prints one line a shape and one JSON line
of sums, prefixed by `tag`; run it once per source tree to compare two
versions on one card. Needs a card.
"""

from __future__ import annotations

import json
import sys

import torch

from ..ops import swin_train as st

# (n, M, N, launches a step): HTS-AT stages 0-2 at B=64 (n = 64 H W, C 96,
# 192, 384, hidden 4C, qkv 3 heads 32), then Audio-MAE ViT-B at B=64 x 160
COLA = [(64 * (64 >> i) ** 2, M, N, 2 * d)
        for i, (C, heads, d) in enumerate(((96, 4, 2), (192, 8, 2), (384, 16, 6)))
        for M, N in ((4 * C, C), (C, 4 * C), (3 * heads * 32, C), (C, heads * 32))]
AUDIOMAE = [(64 * 160, M, N, 12) for M, N in ((3072, 768), (768, 3072), (2304, 768), (768, 768))]


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
    tag = argv[0] if argv else "swin_wgrad"
    if not torch.cuda.is_available():
        print("wgrad_time: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version is an f32 reference
    g = torch.Generator().manual_seed(0)
    sums = {}
    for step, shapes in (("cola", COLA), ("audiomae", AUDIOMAE)):
        k_sum = l_sum = 0.0
        for n, M, N, k in shapes:
            a = torch.randn(n, M, generator=g).to("cuda", torch.bfloat16)
            b = torch.randn(n, N, generator=g).to("cuda", torch.bfloat16)
            got, want = st.swin_wgrad(a, b), st.wgrad_ref(a, b)
            cos = float((got.double() * want.double()).sum()
                        / (got.double().norm() * want.double().norm()))
            same = bool(torch.equal(got, st.swin_wgrad(a, b)))
            k_ms = _ms(lambda: st.swin_wgrad(a, b))
            l_ms = _ms(lambda: torch.mm(a.t(), b))
            k_sum += k * k_ms
            l_sum += k * l_ms
            print(tag, f"{step} ({n}, {M}) x ({n}, {N}) x{k}: cos {cos:.8f} bitwise {same} "
                  f"swin_wgrad {k_ms:.4f} ms torch.mm {l_ms:.4f} ms ({k_ms / l_ms:.2f}x)",
                  flush=True)
            del a, b
        sums[step] = {"swin_wgrad_ms": round(k_sum, 4), "torch_mm_ms": round(l_sum, 4)}
    sums["total"] = {q: round(sums["cola"][q] + sums["audiomae"][q], 4)
                     for q in ("swin_wgrad_ms", "torch_mm_ms")}
    print(tag, json.dumps(sums), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
