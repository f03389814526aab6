"""Times of swin_wgrad, the weight-gradient product dW = A^T B, and of
swin_reduce, the in-order column sum, at the shapes of one COLA step and
one Audio-MAE step, against torch.mm and sum(0); SHA-1s of the backward
halves' gradients.

    python -m heart_murmur_detection_tpu_torch.bench.wgrad_time [tag]

The products of a COLA continued-pretraining step of operaCT at B=64 (the
four weight products of each train block of HTS-AT stages 0-2: 2, 2 and 6
blocks at each of the two shifts) and of an Audio-MAE step at B=64 (160
tokens a clip, 12 blocks), on random bf16 operands (seed 0): for each shape
the cosine against the float32 product, whether two launches agree bitwise,
and the CUDA-event time a launch of swin_wgrad (the whole product, every
launch it takes) and of torch.mm(a.t(), b); then the step sums, each shape
weighted by its launches a step. Then swin_reduce at the (S, L) of the
backward wrappers' partial rows at the same steps (reduce_shapes), on
random float32 partials: bitwise equal to the in-order sum (reduce_ref),
and its CUDA-event time against part.sum(0) (which splits S, so sums in
another order), timed in turns, with the step sums, each call's device
time (torch.profiler) and host time. Last, the SHA-1 of
every gradient leaf of the swin backward halves at chip_smoke.py phase 7's
shapes and of the ViT ones at phase 14's CP shapes, on seeded inputs
(grad_sha1): two trees whose kernels sum in the same order print the same.
Prints one line a shape and JSON lines of sums and hashes, prefixed by
`tag`; run it once per source tree to compare two versions on one card.
Needs a card.
"""

from __future__ import annotations

import hashlib
import json
import sys
import time

import numpy as np
import torch

from ..ops import swin, vit
from ..ops import swin_train as st
from ..ops import vit_train as vt

# (n, M, N, launches a step): HTS-AT stages 0-2 at B=64 (n = 64 H W, C 96,
# 192, 384, hidden 4C, qkv 3 heads 32), then Audio-MAE ViT-B at B=64 x 160
COLA = [(64 * (64 >> i) ** 2, M, N, 2 * d)
        for i, (C, heads, d) in enumerate(((96, 4, 2), (192, 8, 2), (384, 16, 6)))
        for M, N in ((4 * C, C), (C, 4 * C), (3 * heads * 32, C), (C, heads * 32))]
AUDIOMAE = [(64 * 160, M, N, 12) for M, N in ((3072, 768), (768, 3072), (2304, 768), (768, 768))]
# the swin backward halves of a COLA step: (C, heads, blocks at each shift)
# of HTS-AT stages 0-2 at B=64, H = W = 64 >> stage
STAGES = ((96, 4, 2), (192, 8, 2), (384, 16, 6))
# the ViT backward halves of phase 14: (C, heads, Np, n_real) at B=64
VIT_CP = ((768, 12, 160, 154), (384, 6, 320, 308), (384, 6, 80, 77))


def reduce_shapes(sms: int = 132):
    """(S, L, launches a step) of swin_reduce in a COLA step and an Audio-MAE
    step: the partial rows of swin_mlp_bwd ([db1 | db2 | dLN2 w | dLN2 b],
    L = 4C + 3C) and swin_attn_bwd ([rel-pos bias | db_qkv | db_proj | dLN1],
    L = heads 4096 + 3 heads HDP + 3C) at each stage, and of vit_mlp_bwd
    (L = 7C) and vit_attn_bwd (L = 6C) at the Audio-MAE CP shape, S as the
    wrappers size them on a card of `sms` SMs (the launch plans)."""
    from ..ops.swin_plan import attn_bwd_plan, mlp_bwd_plan

    cola = []
    for i, (C, heads, d) in enumerate(STAGES):
        H = 64 >> i
        for plan in (mlp_bwd_plan(64 * H * H, C, 4 * C, sms), attn_bwd_plan(64, H, H, C, heads, sms)):
            cola.append((plan.part_rows, plan.part_cols, 2 * d))
    n, C = 64 * 160, 768
    mae = [(mlp_bwd_plan(n, C, 4 * C, sms, kmul=False).part_rows, 7 * C, 12),
           (st._blocks_for(n // st.TOKEN_TILE)[1], 6 * C, 12)]
    return cola, mae


def _sd(C, r):
    f = lambda *sh: torch.from_numpy((r.standard_normal(sh) * 0.05).astype(np.float32))
    return {"norm1.weight": 1 + f(C), "norm1.bias": f(C), "attn.qkv.weight": f(3 * C, C),
            "attn.qkv.bias": f(3 * C), "attn.proj.weight": f(C, C), "attn.proj.bias": f(C),
            "norm2.weight": 1 + f(C), "norm2.bias": f(C), "mlp.fc1.weight": f(4 * C, C),
            "mlp.fc1.bias": f(4 * C), "mlp.fc2.weight": f(C, 4 * C), "mlp.fc2.bias": f(C)}


def _sha1(grads: dict) -> str:
    h = hashlib.sha1()
    for k in sorted(grads):
        h.update(k.encode())
        h.update(grads[k].float().cpu().numpy().tobytes())
    return h.hexdigest()


def grad_sha1() -> dict:
    """{shape: SHA-1 of dx / dh1 and every gradient leaf}: swin_mlp_bwd and
    swin_attn_bwd at the COLA stage 0-2 shapes (B=64, shift 0 and the
    stage's shift with its mask), vit_mlp_bwd and vit_attn_bwd at the ViT
    CP shapes, on inputs and weights drawn from fixed seeds."""
    from ..models.htsat import _shift_attn_mask

    dev, out = torch.device("cuda"), {}
    for i, (C, heads, _) in enumerate(STAGES):
        H, r = 64 >> i, np.random.default_rng(100 + i)
        bias = torch.from_numpy((r.standard_normal((heads, 64, 64))).astype(np.float32))
        p = swin.prep_block(_sd(C, r), heads, bias, torch.bfloat16, dev)
        t = lambda s: torch.from_numpy((r.standard_normal((64, H, H, C)) * s).astype(np.float32)).to(
            dev, torch.bfloat16)
        x, dy = t(0.5), t(0.1)
        k = torch.tensor([0.0, 1 / 0.9, 1.0, 1 / 0.9] * 16, device=dev)
        for shift in (0, 4 if H > 8 else 0):
            m = torch.from_numpy(_shift_attn_mask(H, H, 8, shift)).to(dev) if shift else None
            dh1, gm = st.swin_mlp_bwd(x, dy, k, p)
            dx, ga = st.swin_attn_bwd(x, dh1, k, p, m, shift)
            out[f"swin C={C} shift={shift}"] = _sha1({"dh1": dh1, "dx": dx, **{
                f"mlp.{q}": v for q, v in gm.items()}, **{f"attn.{q}": v for q, v in ga.items()}})
    for C, heads, Np, n_real in VIT_CP:
        r = np.random.default_rng(200 + Np)
        p = vit.prep_vit_block(_sd(C, r), heads, torch.bfloat16, dev)
        t = lambda s: torch.from_numpy((r.standard_normal((64, Np, C)) * s).astype(np.float32)).to(
            dev, torch.bfloat16)
        x, dy = t(0.5), t(0.1)
        dy[:, n_real:] = 0
        dh1, gm = vt.vit_mlp_bwd(x, dy, p)
        dx, ga = vt.vit_attn_bwd(x, dh1, p, n_real)
        out[f"vit C={C} Np={Np}"] = _sha1({"dh1": dh1, "dx": dx, **{
            f"mlp.{q}": v for q, v in gm.items()}, **{f"attn.{q}": v for q, v in ga.items()}})
    torch.cuda.synchronize()
    return out


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


def _device_ms(fn, n: int = 20) -> float:
    """Device time a call of fn: torch.profiler's CUDA kernel rows over n
    calls (the window holds nothing else), in ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0.0) for e in prof.events()
             if str(getattr(e, "device_type", "")).endswith("CUDA"))
    return us / n / 1e3


def _host_ms(fn, n: int = 50) -> float:
    """Host time a call of fn, launches queued without a synchronise, in ms."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t) / n * 1e3
    torch.cuda.synchronize()
    return host


def time_reduce(tag: str, g: torch.Generator) -> dict:
    """swin_reduce against sum(0) at reduce_shapes(): a line a shape (CUDA
    events back to back, three turns a side, the median; the device time by
    the profiler; the host time a call) and the step sums."""
    red = {}
    for step, shapes in zip(("cola", "audiomae"), reduce_shapes(swin.sm_count(torch.device("cuda")))):
        k_sum = l_sum = 0.0
        for S, L, k in shapes:
            part = torch.randn(S, L, generator=g).to("cuda")
            same = bool(torch.equal(st.swin_reduce(part), st.reduce_ref(part)))
            kern, lib = (lambda: st.swin_reduce(part)), (lambda: part.sum(0))
            k_ms, l_ms = [], []
            for _ in range(3):  # in turns
                k_ms.append(_ms(kern))
                l_ms.append(_ms(lib))
            k_ms, l_ms = sorted(k_ms)[1], sorted(l_ms)[1]
            k_sum += k * k_ms
            l_sum += k * l_ms
            print(tag, f"reduce {step} ({S}, {L}) x{k}: in-order bitwise {same} swin_reduce "
                  f"{k_ms:.4f} ms sum(0) {l_ms:.4f} ms ({k_ms / l_ms:.2f}x); device "
                  f"{_device_ms(kern):.4f} / {_device_ms(lib):.4f} ms, host "
                  f"{_host_ms(kern):.4f} / {_host_ms(lib):.4f} ms a call", flush=True)
            del part
        red[step] = {"swin_reduce_ms": round(k_sum, 4), "sum0_ms": round(l_sum, 4)}
    red["total"] = {q: round(red["cola"][q] + red["audiomae"][q], 4)
                    for q in ("swin_reduce_ms", "sum0_ms")}
    print(tag, json.dumps(red), flush=True)
    return red


def time_wgrad(tag: str, g: torch.Generator) -> dict:
    """swin_wgrad against torch.mm at COLA and AUDIOMAE: a line a shape and
    the step sums."""
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
    return sums


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tag = argv[0] if argv else "swin_wgrad"
    if not torch.cuda.is_available():
        print("wgrad_time: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version is an f32 reference
    g = torch.Generator().manual_seed(0)
    time_reduce(tag, g)  # first: torch.profiler traces a young process whole
    time_wgrad(tag, g)
    print(tag, "sha1", json.dumps(grad_sha1()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
