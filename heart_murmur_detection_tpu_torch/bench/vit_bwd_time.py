"""Times of vit_attn_bwd (the attention half of the ViT training backward)
at the phase-14 shapes of chip_smoke.py, and of vit_qkv at both towers'
eval shapes.

    python -m heart_murmur_detection_tpu_torch.bench.vit_bwd_time [tag]

For each backward shape (Audio-MAE CP B=64 x 160 tokens, 154 real, C 768;
OPERA-GT MAE CP B=64 x 320 / 308 and x 80 / 77, C 384; operaGT
fine-tuning B=4 x 1040 / 1025, C 384), one random block (seed 0), random
tokens and an incoming gradient zero on the padded rows:
  - the CUDA-event time of one vit_attn_bwd_launch (the whole call, every
    grid launch in it; 3 warm-up calls, mean of 20), and of its plain
    version vit_attn_bwd_ref;
  - the device time of each grid launch inside the call, by kernel name
    with its template arguments (vit_attn_bwd_mm_kernel<1> is do, <0> dh),
    from torch.profiler over 3 calls (taken first, in a fresh process: the
    card machine's profiler drops device records later in a process);
  - the same function as a chain of library calls: layer_norm, addmm for
    qkv, mm for do, SDPA's backward (keys sliced to n_real), mm for dh and
    the LayerNorm backward (aten.native_layer_norm_backward), and SDPA's
    backward alone, the yardstick chip_smoke.py reports.
For vit_qkv at operaGT (B=16 x 1040, C 384) and Audio-MAE (B=16 x 528, C
768): the CUDA-event time of a launch against torch.addmm on the LN output.
Last, a SHA-1 of swin_wgrad's and vit_proj's outputs on fixed inputs (the
other users of the GEMM core, which two trees must compute bitwise alike).
Prints one line a shape and one JSON line of the Audio-MAE CP step's sums
(12 launches), the per-launch times and the hashes, each prefixed by
`tag`; run it once per source tree to compare two versions on one card.
Needs a card.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..ops import vit
from ..ops import vit_train as vt

# (tag, C, heads, Np, n_real, B): chip_smoke.py's VIT_TRAIN_SHAPES
BWD_SHAPES = (("audiomae", 768, 12, 160, 154, 64), ("mae", 384, 6, 320, 308, 64),
              ("mae short", 384, 6, 80, 77, 64), ("operaGT fine-tune", 384, 6, 1040, 1025, 4))
# (tower, C, heads, Np, B): the eval shapes of phase 9
QKV_SHAPES = (("operaGT", 384, 6, 1040, 16), ("audiomae", 768, 12, 528, 16))


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


def _params(C, heads, seed):
    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g) * 0.05
    sd = {"norm1.weight": 1 + f(C), "norm1.bias": f(C), "attn.qkv.weight": f(3 * C, C) * 2,
          "attn.qkv.bias": f(3 * C), "attn.proj.weight": f(C, C), "attn.proj.bias": f(C),
          "norm2.weight": 1 + f(C), "norm2.bias": f(C), "mlp.fc1.weight": f(4 * C, C),
          "mlp.fc1.bias": f(4 * C), "mlp.fc2.weight": f(C, 4 * C), "mlp.fc2.bias": f(C)}
    return vit.prep_vit_block(sd, heads, torch.bfloat16, "cuda")


def _inputs(C, Np, n_real, B, seed):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(B, Np, C, generator=g) * 0.5).to("cuda", torch.bfloat16)
    dh1 = (torch.randn(B, Np, C, generator=g) * 0.1).to("cuda", torch.bfloat16)
    dh1[:, n_real:] = 0  # the caller's y[:, :n_real] slice
    return x, dh1


def _split(fn, n: int = 3) -> dict:
    """Device ms a call of fn by kernel name, from one torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        name = e.key.split("(")[0].replace("void ", "").replace("hmdt::", "")
        out[name] = round(out.get(name, 0.0) + us / 1e3 / n, 4)
    return out


def library_chain(x, dh1, p, n_real):
    """vit_attn_bwd's function as library calls on the same inputs: a
    closure running LN1, the qkv addmm, the do mm, SDPA's backward, the dh mm
    and the LN1 backward (weights in bf16, the forward of SDPA taken once
    outside), and a closure of SDPA's backward alone."""
    B, Np, C = x.shape
    H = p.heads
    n = B * Np
    x2, dh2 = x.reshape(n, C), dh1.reshape(n, C)
    lw, lb, bq = (t.to(torch.bfloat16) for t in (p.ln1_w, p.ln1_b, p.b_qkv))
    wq, wp = p.w_qkv, p.w_proj
    hh = F.layer_norm(x2, (C,), lw, lb, vit.LN_EPS)
    qkv = torch.addmm(bq, hh, wq.t()).reshape(B, Np, 3, H, 64).permute(2, 0, 3, 1, 4)
    q = qkv[0].detach().requires_grad_()
    k = qkv[1][:, :, :n_real].detach().requires_grad_()
    v = qkv[2][:, :, :n_real].detach().requires_grad_()
    o = F.scaled_dot_product_attention(q, k, v, scale=1.0)
    do0 = torch.mm(dh2, wp).reshape(B, Np, H, 64).permute(0, 2, 1, 3)

    def sdpa_bwd(do=do0):
        return torch.autograd.grad(o, (q, k, v), do, retain_graph=True)

    def chain():
        h, mean, rstd = torch.ops.aten.native_layer_norm(x2, [C], lw, lb, vit.LN_EPS)
        torch.addmm(bq, h, wq.t())
        do = torch.mm(dh2, wp).reshape(B, Np, H, 64).permute(0, 2, 1, 3)
        dq, dk, dv = sdpa_bwd(do)
        dk = F.pad(dk, (0, 0, 0, Np - n_real))
        dv = F.pad(dv, (0, 0, 0, Np - n_real))
        dqkv = torch.cat([t.permute(0, 2, 1, 3).reshape(n, C) for t in (dq, dk, dv)], 1)
        dh = torch.mm(dqkv, wq)
        torch.ops.aten.native_layer_norm_backward(dh, x2, [C], mean, rstd, lw, lb,
                                                  [True, True, True])

    return chain, sdpa_bwd


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tag = argv[0] if argv else "vit_bwd"
    if not torch.cuda.is_available():
        print("vit_bwd_time: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version is an f32 reference
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(tag, smi, flush=True)
    cases = []
    for i, (name, C, heads, Np, n_real, B) in enumerate(BWD_SHAPES):
        p = _params(C, heads, i)
        x, dh1 = _inputs(C, Np, n_real, B, 10 + i)
        cases.append((name, C, heads, Np, n_real, B, p, x, dh1))
    # the per-kernel splits first, while the process is young
    splits = {c[0]: _split(lambda c=c: vt.vit_attn_bwd_launch(c[7], c[8], c[6], c[4]))
              for c in cases}
    summary = {"card": smi}
    for name, C, heads, Np, n_real, B, p, x, dh1 in cases:
        got = vt.vit_attn_bwd_launch(x, dh1, p, n_real)[0]
        want = vt.vit_attn_bwd_ref(x, dh1, p, n_real)[0]
        a = (got.double() - dh1.double()).flatten()
        b = (want.double() - dh1.double()).flatten()
        row = {"dx_branch_cos": round(float(a @ b / (a.norm() * b.norm())), 8)}
        row["ms"] = round(_ms(lambda: vt.vit_attn_bwd_launch(x, dh1, p, n_real)), 4)
        row["plain_ms"] = round(_ms(lambda: vt.vit_attn_bwd_ref(x, dh1, p, n_real), 3, 1), 4)
        chain, sdpa_bwd = library_chain(x, dh1, p, n_real)
        row["library_chain_ms"] = round(_ms(chain), 4)
        row["sdpa_bwd_ms"] = round(_ms(sdpa_bwd), 4)
        row["split_profiler_ms"] = splits[name]
        print(tag, f"vit_attn_bwd {name} B={B} Np={Np} n_real={n_real} C={C}:",
              json.dumps(row), flush=True)
        if name == "audiomae":
            summary["audiomae_cp_step_12"] = {
                k: round(12 * row[k], 4)
                for k in ("ms", "plain_ms", "library_chain_ms", "sdpa_bwd_ms")}
        summary[f"vit_attn_bwd {name}"] = row["ms"]
        del chain, sdpa_bwd
    for tower, C, heads, Np, B in QKV_SHAPES:
        p = _params(C, heads, 7)
        x = (torch.randn(B, Np, C, generator=torch.Generator().manual_seed(8)) * 0.5).to(
            "cuda", torch.bfloat16)
        got, want = vit.vit_qkv(x, p), vit.vit_qkv_ref(x, p)
        cos = float((got.double() * want.double()).sum()
                    / (got.double().norm() * want.double().norm()))
        h = vit._ln(x, p.ln1_w, p.ln1_b, vit.LN_EPS).to(torch.bfloat16).reshape(-1, C)
        bq = p.b_qkv.to(torch.bfloat16)
        k_ms = _ms(lambda: vit.vit_qkv(x, p))
        l_ms = _ms(lambda: torch.addmm(bq, h, p.w_qkv.t()))
        print(tag, f"vit_qkv {tower} B={B} Np={Np} C={C}: cos {cos:.8f} kernel {k_ms:.4f} ms "
              f"addmm {l_ms:.4f} ms ({k_ms / l_ms:.2f}x)", flush=True)
        summary[f"vit_qkv {tower}"] = round(k_ms, 4)
        summary[f"addmm {tower}"] = round(l_ms, 4)
    # the other users of the GEMM core, whose outputs the core's changes
    # must leave bitwise as they were: a hash of each output
    from ..ops import swin_train as st

    g = torch.Generator().manual_seed(9)
    a = torch.randn(10240, 2304, generator=g).to("cuda", torch.bfloat16)
    b = torch.randn(10240, 768, generator=g).to("cuda", torch.bfloat16)
    p = _params(768, 12, 9)
    x = torch.randn(64, 160, 768, generator=g).to("cuda", torch.bfloat16)
    o = torch.randn(64, 160, 768, generator=g).to("cuda", torch.bfloat16)
    for name, out in (("swin_wgrad", st.swin_wgrad(a, b)), ("vit_proj", vit.vit_proj(o, x, p))):
        summary[f"sha1 {name}"] = hashlib.sha1(out.float().cpu().numpy().tobytes()).hexdigest()
    print(tag, json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
