"""Times of the two backward kernels of the swin and ViT training blocks,
swin_mlp_bwd (also vit_mlp_bwd) and swin_attn_bwd, at the geometries a COLA
step and an Audio-MAE CP step launch.

    python -m heart_murmur_detection_tpu_torch.bench.swin_bwd_time [tag]

For each HTS-AT stage a COLA step trains on the kernels (C 96, 192, 384 on
64 x 64 down to 16 x 16 maps, B = 64, DropPath multipliers with a 0 among
them) and each shift (0 and 4), and for vit_mlp_bwd at the MAE shapes of
chip_smoke.py's phase 14 (Audio-MAE B = 64 x 160 at C 768; OPERA-GT B = 64
x 320 and x 80 and B = 4 x 1040 at C 384), one random block and random
activations and gradients:
  - the wrapper call's CUDA-event time (every grid launch of the call): 5
    turns of 10 back-to-back calls (2 warm-up calls first), the median and
    the spread of the turns;
  - its bound: the larger of the bytes (activations and incoming gradient
    in, the input gradient out, the weights once) over 3.35 TB/s and the
    operations of its share of the backward function (the fc1 recompute
    and two data products; the qkv recompute, do, dh and the six window
    products) over 989 TFLOP/s, as chip_smoke.py counts them;
  - the plain version's time (one turn of 3 calls);
  - the library chain: the autograd backward of the same half written as
    library calls in bf16 (MLP: layer_norm, linear, gelu, linear and the
    multiplier; attention: the window partition, layer_norm, the qkv
    linear, the window matmuls with the bias and mask, softmax, proj and
    the multiplier), a yardstick only;
  - the device time a call by kernel name, from torch.profiler over 3 calls
    of each case in a fresh child process (the card machine's profiler
    drops device records once a process has lived some tens of seconds).

Prints a line a case and one JSON line of the step sums (a COLA step: each
stage's depth of calls at each shift; an Audio-MAE CP step: 12 vit_mlp_bwd
calls), each prefixed by `tag`. It runs from any tree whose
ops/swin_train.py and ops/vit_train.py have the wrappers swin_mlp_bwd_launch,
swin_attn_bwd_launch and vit_mlp_bwd_launch, so that two versions compare
on one card in turns (parent, change, change, parent). Needs a card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..models.htsat import _shift_attn_mask
from ..ops import swin, vit
from ..ops import swin_train as st
from ..ops import vit_train as vt
from .swin_fwd_time import BF16_FLOPS, HBM_BPS, _sd, _swin_params

# (C, heads, H = W, calls at each shift a COLA step) of HTS-AT stages 0-2
STAGES = ((96, 4, 64, 2), (192, 8, 32, 2), (384, 16, 16, 6))
B_COLA = 64
# (name, C, heads, B, Np, calls an Audio-MAE CP step) of vit_mlp_bwd
VIT_CASES = (("audiomae CP", 768, 12, 64, 160, 12), ("mae CP", 384, 6, 64, 320, 0),
             ("mae CP short", 384, 6, 64, 80, 0), ("operaGT fine-tune", 384, 6, 4, 1040, 0))


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


def _turns(fn, n: int = 5) -> tuple:
    t = [_ms(fn) for _ in range(n)]
    return statistics.median(t), min(t), max(t)


def bwd_work(n, C, heads, mask_numel=0):
    """(bytes, operations) of swin_mlp_bwd's and swin_attn_bwd's shares of
    the training block's backward function for n tokens (chip_smoke.py's
    _bwd_work)."""
    hid = 4 * C
    mlp = 6 * n * C + 2 * 2 * hid * C + 4 * (3 * C + hid), 6 * n * C * hid
    attn = 6 * n * C + 2 * 4 * C * C + 4 * (6 * C + heads * 4096) + 4 * mask_numel
    return mlp, (attn, n * (14 * C * C + 768 * C))


def _bound(nbytes, ops):
    tb, to = nbytes / HBM_BPS, ops / BF16_FLOPS
    return max(tb, to) * 1e3, "operations" if to >= tb else "bytes"


def _grad_call(out, inputs, g):
    return lambda: torch.autograd.grad(out, inputs, g, retain_graph=True)


def mlp_bwd_chain(h1, dy, k, p, eps, dtype=torch.bfloat16):
    """The MLP half's backward as the autograd backward of library calls in
    `dtype` (bf16, or float32 with TF32 left to the caller) on the same
    inputs (h1 (..., C), the kernel layout p, a per-sample multiplier k or
    None): a closure of one backward call."""
    bf = lambda t: t.detach().to(dtype).requires_grad_()
    C = h1.shape[-1]
    x = h1.detach().reshape(h1.shape[0], -1, C).requires_grad_()
    lw, lb, w1, b1, w2, b2 = (bf(t) for t in (p.ln2_w, p.ln2_b, p.w_fc1, p.b_fc1, p.w_fc2, p.b_fc2))
    m = F.linear(F.gelu(F.linear(F.layer_norm(x, (C,), lw, lb, eps), w1, b1)), w2, b2)
    if k is not None:
        m = k.to(dtype).reshape(-1, 1, 1) * m
    return _grad_call(x + m, (x, lw, lb, w1, b1, w2, b2), dy.reshape(x.shape))


def attn_bwd_chain(x, dh1, k, p, mask=None, shift=0, dtype=torch.bfloat16):
    """The attention half's backward as the autograd backward of library
    calls in `dtype` (bf16, or float32) on the same inputs (x (B, H, W, C),
    the kernel layout p with its padded q / k / v rows taken back to hd, the
    gathered rel-pos bias, the mask, the multiplier k): a closure of one
    backward call."""
    B, H, W, C = x.shape
    heads, hd = p.heads, p.hd
    bf = lambda t: t.detach().to(dtype).requires_grad_()
    rows = lambda t: t.reshape(3, heads, -1, *t.shape[1:])[:, :, :hd].reshape(3 * C, *t.shape[1:])
    lw, lb, wq, bq, wp, bp, bias = (bf(t) for t in (p.ln1_w, p.ln1_b, rows(p.w_qkv), rows(p.b_qkv),
                                                    p.w_proj, p.b_proj, p.bias))
    xi = x.detach().requires_grad_()
    xs = torch.roll(xi, (-shift, -shift), (1, 2)) if shift else xi
    xw = xs.reshape(B, H // 8, 8, W // 8, 8, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, 64, C)
    qkv = F.linear(F.layer_norm(xw, (C,), lw, lb, 1e-5), wq, bq)
    q, kk, v = qkv.reshape(-1, 64, 3, heads, hd).permute(2, 0, 3, 1, 4)
    s = (q * hd ** -0.5) @ kk.transpose(-1, -2) + bias
    if mask is not None:
        s = (s.reshape(B, -1, heads, 64, 64) + mask.to(dtype)[None, :, None]).reshape(s.shape)
    o = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(-1, 64, C)
    y = (F.linear(o, wp, bp).reshape(B, -1, 64, C) * k.to(dtype).reshape(-1, 1, 1, 1))
    y = y.reshape(B, H // 8, W // 8, 8, 8, C).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)
    y = torch.roll(y, (shift, shift), (1, 2)) if shift else y
    return _grad_call(xi + y, (xi, lw, lb, wq, bq, wp, bp, bias), dh1)


def cases():
    """(name, kernel closure, plain closure, chain closure, calls a step,
    (bytes, ops), step) of every case."""
    out = []
    for C, heads, H, d in STAGES:
        p = _swin_params(C, heads)
        g = torch.Generator().manual_seed(C + 7)
        x = (torch.randn(B_COLA, H, H, C, generator=g) * 0.5).to("cuda", torch.bfloat16)
        dy = (torch.randn(B_COLA, H, H, C, generator=g) * 0.1).to("cuda", torch.bfloat16)
        k = torch.tensor([0.0, 1 / 0.9, 1.0, 1 / 0.9] * (B_COLA // 4), device="cuda")
        for s in (0, 4):
            m = torch.from_numpy(_shift_attn_mask(H, H, 8, s)).to("cuda") if s else None
            h1 = swin.swin_attn_ref(x, p, m, s, kmul=k)
            dh1 = st.swin_mlp_bwd_ref(h1, dy, k, p)[0]
            (wm, om), (wa, oa) = bwd_work(B_COLA * H * H, C, heads, 0 if m is None else m.numel())
            tag = f"C={C} H=W={H} shift={s} B={B_COLA}"
            out.append((f"swin_mlp_bwd {tag}",
                        lambda h1=h1, dy=dy, k=k, p=p: st.swin_mlp_bwd_launch(h1, dy, k, p),
                        lambda h1=h1, dy=dy, k=k, p=p: st.swin_mlp_bwd_ref(h1, dy, k, p),
                        mlp_bwd_chain(h1, dy, k, p, 1e-5), d, (wm, om), "swin_mlp_bwd COLA step"))
            out.append((f"swin_attn_bwd {tag}",
                        lambda x=x, dh1=dh1, k=k, p=p, m=m, s=s: st.swin_attn_bwd_launch(x, dh1, k, p, m, s),
                        lambda x=x, dh1=dh1, k=k, p=p, m=m, s=s: st.swin_attn_bwd_ref(x, dh1, k, p, m, s),
                        attn_bwd_chain(x, dh1, k, p, m, s), d, (wa, oa), "swin_attn_bwd COLA step"))
    for name, C, heads, B, Np, n in VIT_CASES:
        p = vit.prep_vit_block(_sd(C, C + 2), heads, torch.bfloat16, "cuda")
        g = torch.Generator().manual_seed(Np + B)
        h1 = (torch.randn(B, Np, C, generator=g) * 0.5).to("cuda", torch.bfloat16)
        dy = (torch.randn(B, Np, C, generator=g) * 0.1).to("cuda", torch.bfloat16)
        (wm, om), _ = bwd_work(B * Np, C, heads)
        out.append((f"vit_mlp_bwd {name} B={B} Np={Np} C={C}",
                    lambda h1=h1, dy=dy, p=p: vt.vit_mlp_bwd_launch(h1, dy, p),
                    lambda h1=h1, dy=dy, p=p: vt.vit_mlp_bwd_ref(h1, dy, p),
                    mlp_bwd_chain(h1, dy, None, p, vit.LN_EPS), n, (wm, om),
                    "vit_mlp_bwd Audio-MAE CP step"))
    return out


def profile_main() -> int:
    """The child: the device ms a call of each case by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    res = {}
    for name, kern, *_ in cases():
        kern()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                kern()
            torch.cuda.synchronize()
        row = {}
        for e in prof.key_averages():
            if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                continue
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            kname = e.key.split("(")[0].replace("void ", "").replace("hmdt::", "")
            row[kname] = round(row.get(kname, 0.0) + us / 1e3 / 3, 4)
        res[name] = row
    print(json.dumps(res))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("swin_bwd_time: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions are f32 references
    if argv[:1] == ["--profile"]:
        return profile_main()
    tag = argv[0] if argv else "swin_bwd"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(tag, smi, flush=True)
    child = subprocess.run([sys.executable, "-m", __spec__.name, "--profile"],
                           capture_output=True, text=True)
    lines = child.stdout.strip().splitlines()
    device = json.loads(lines[-1]) if child.returncode == 0 and lines else {}
    if child.returncode:
        print(tag, "profile child failed:", child.stderr[-2000:], flush=True)
    sums = {"card": smi}
    for name, kern, plain, chain, n, work, step in cases():
        got, again = kern(), kern()
        torch.cuda.synchronize()
        same = torch.equal(got[0], again[0]) and torch.equal(got[2], again[2])
        med, lo, hi = _turns(kern)
        bound, by = _bound(*work)
        row = {"ms": round(med, 4), "turns_min_max": [round(lo, 4), round(hi, 4)],
               "bound_ms": round(bound, 4), "bound_by": by, "share_of_bound": round(bound / med, 4),
               "plain_ms": round(_ms(plain, 3, 1), 4), "library_chain_ms": round(_turns(chain)[0], 4),
               "bitwise_repeatable": bool(same), "device_ms_by_kernel": device.get(name, {})}
        print(tag, name + ":", json.dumps(row), flush=True)
        if not n:
            continue
        s = sums.setdefault(step, {"ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0,
                                   "library_chain_ms": 0.0, "calls": 0})
        for key in ("ms", "bound_ms", "plain_ms", "library_chain_ms"):
            s[key] = round(s[key] + n * row[key], 4)
        s["calls"] += n
    print(tag, "per step:", json.dumps(sums), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
