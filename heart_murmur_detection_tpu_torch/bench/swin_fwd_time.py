"""Times of the two forward kernels of the swin and ViT towers, swin_attn and
swin_mlp (also vit_mlp), at the geometries the towers launch.

    python -m heart_murmur_detection_tpu_torch.bench.swin_fwd_time [tag]

For each operaCT stage (HTS-AT C 96, 192, 384, 768 on 64 x 64 down to 8 x 8
maps) at B = 16 (the serving batch) and B = 64 (the throughput batch), each
shift the stage runs (0 and 4; stage 3 only 0), one random block (seed =
C) and random tokens:
  - the kernel's CUDA-event time: 5 turns of 20 back-to-back launches (3
    warm-up launches first), the median and the spread of the turns;
  - its bound: the larger of the bytes (x in and out, the weights, the
    biases, the gathered rel-pos bias and the mask, each once) over 3.35
    TB/s and the operations (qkv with hd padded to 32, the window products,
    proj; or fc1 and fc2) over 989 TFLOP/s, as chip_smoke.py counts them;
  - the plain version's time (one turn of 5 launches);
  - for swin_mlp, the same function as a chain of library calls in bf16
    (F.layer_norm, addmm, exact gelu, addmm, the residual add), which is
    information and not a one-call yardstick;
  - the device time a launch by kernel name, from torch.profiler over 3
    launches of each case, taken in a fresh child process (the card
    machine's profiler drops device records once a process has lived some
    tens of seconds).
vit_mlp likewise at operaGT B = 16 and 64 x 1040 tokens (C 384), Audio-MAE
B = 16 and 32 x 528 (C 768) and the Audio-MAE CP shape B = 64 x 160.

Prints a line a case and one JSON line of the per-forward sums (operaCT
at B = 16 and 64: swin_attn at depth / 2 launches a shift of a shifted
stage, swin_mlp at depth launches a stage, depths 2, 2, 6, 2; operaGT:
12 vit_mlp launches), each prefixed by `tag`. It runs from any tree whose
ops/swin.py and ops/vit.py have these entry points, so that two versions
compare on one card in turns (parent, change, change, parent). Needs a
card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..models.htsat import _relative_position_index, _shift_attn_mask
from ..ops import swin, vit

HBM_BPS = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16
# (C, heads, H = W, depth, shift) of the operaCT stages
STAGES = ((96, 4, 64, 2, 4), (192, 8, 32, 2, 4), (384, 16, 16, 6, 4), (768, 32, 8, 2, 0))
# (name, C, heads, B, Np) of vit_mlp
VIT_CASES = (("operaGT", 384, 6, 16, 1040), ("operaGT", 384, 6, 64, 1040),
             ("audiomae", 768, 12, 16, 528), ("audiomae", 768, 12, 32, 528),
             ("audiomae CP", 768, 12, 64, 160))
DEPTH_VIT = 12


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


def _turns(fn, n: int = 5) -> tuple:
    """(median, min, max) of n CUDA-event turns of fn."""
    t = [_ms(fn) for _ in range(n)]
    return statistics.median(t), min(t), max(t)


def _bound_ms(nbytes: float, ops: float) -> tuple:
    tb, to = nbytes / HBM_BPS, ops / BF16_FLOPS
    return max(tb, to) * 1e3, "operations" if to >= tb else "bytes"


def _attn_work(B, H, W, C, heads, shift):
    n, Cp = B * H * W, heads * 32
    nbytes = 4 * n * C + 2 * (3 * Cp * C + C * C) + 4 * (3 * Cp + 3 * C + heads * 4096)
    nbytes += 4 * (H * W // 64) * 4096 if shift else 0
    return nbytes, n * (8 * C * C + 256 * C)


def _mlp_work(n, C):
    return 4 * n * C + 16 * C * C + 4 * 7 * C, 16 * n * C * C


def _sd(C, seed):
    r = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy((r.standard_normal(s) * 0.05).astype(np.float32))
    return {"norm1.weight": 1 + f(C), "norm1.bias": f(C), "attn.qkv.weight": f(3 * C, C) * 2,
            "attn.qkv.bias": f(3 * C), "attn.proj.weight": f(C, C), "attn.proj.bias": f(C),
            "norm2.weight": 1 + f(C), "norm2.bias": f(C), "mlp.fc1.weight": f(4 * C, C),
            "mlp.fc1.bias": f(4 * C), "mlp.fc2.weight": f(C, 4 * C), "mlp.fc2.bias": f(C)}


def _swin_params(C, heads):
    r = np.random.default_rng(C + 1)
    table = torch.from_numpy((r.standard_normal((225, heads)) * 0.5).astype(np.float32))
    idx = torch.as_tensor(_relative_position_index(8, 8).reshape(-1))
    bias = table[idx].reshape(64, 64, heads).permute(2, 0, 1)
    return swin.prep_block(_sd(C, C), heads, bias, torch.bfloat16, "cuda")


def mlp_chain(x, p, eps):
    """The MLP half as library calls in bf16 on the same inputs."""
    C = x.shape[-1]
    x2 = x.reshape(-1, C)
    bf = lambda t: t.to(torch.bfloat16)
    lw, lb, b1, b2 = bf(p.ln2_w), bf(p.ln2_b), bf(p.b_fc1), bf(p.b_fc2)
    return lambda: torch.addmm(b2, F.gelu(torch.addmm(b1, F.layer_norm(x2, (C,), lw, lb, eps),
                                                      p.w_fc1.t())), p.w_fc2.t()).add_(x2)


def cases():
    """(name, kernel closure, plain closure, chain closure or None, launches
    a forward, (bytes, ops), forward) of every case."""
    out = []
    for B in (16, 64):
        for C, heads, H, depth, sh in STAGES:
            p = _swin_params(C, heads)
            g = torch.Generator().manual_seed(C + B)
            x = (torch.randn(B, H, H, C, generator=g) * 0.5).to("cuda", torch.bfloat16)
            shifts = (0, sh) if sh else (0,)
            for s in shifts:
                m = torch.from_numpy(_shift_attn_mask(H, H, 8, s)).to("cuda") if s else None
                out.append((f"swin_attn B={B} C={C} H=W={H} shift={s}",
                            lambda x=x, p=p, m=m, s=s: swin.swin_attn(x, p, m, s),
                            lambda x=x, p=p, m=m, s=s: swin.swin_attn_ref(x, p, m, s), None,
                            depth // len(shifts), _attn_work(B, H, H, C, heads, s),
                            f"swin_attn operaCT B={B}"))
            out.append((f"swin_mlp B={B} C={C} H=W={H}", lambda x=x, p=p: swin.swin_mlp(x, p),
                        lambda x=x, p=p: swin.swin_mlp_ref(x, p), mlp_chain(x, p, 1e-5), depth,
                        _mlp_work(B * H * H, C), f"swin_mlp operaCT B={B}"))
    for name, C, heads, B, Np in VIT_CASES:
        p = vit.prep_vit_block(_sd(C, C + 2), heads, torch.bfloat16, "cuda")
        g = torch.Generator().manual_seed(Np + B)
        x = (torch.randn(B, Np, C, generator=g) * 0.5).to("cuda", torch.bfloat16)
        out.append((f"vit_mlp {name} B={B} Np={Np} C={C}", lambda x=x, p=p: vit.vit_mlp(x, p),
                    lambda x=x, p=p: vit.vit_mlp_ref(x, p), mlp_chain(x, p, vit.LN_EPS),
                    DEPTH_VIT, _mlp_work(B * Np, C), f"vit_mlp {name} B={B}"))
    return out


def profile_main() -> int:
    """The child: the device ms a launch of each case by kernel name."""
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
            k = e.key.split("(")[0].replace("void ", "").replace("hmdt::", "")
            row[k] = round(row.get(k, 0.0) + us / 1e3 / 3, 4)
        res[name] = row
    print(json.dumps(res))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("swin_fwd_time: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions are f32 references
    if argv[:1] == ["--profile"]:
        return profile_main()
    tag = argv[0] if argv else "swin_fwd"
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
    for name, kern, plain, chain, n, work, fwd in cases():
        got, want, again = kern(), plain(), kern()
        torch.cuda.synchronize()
        med, lo, hi = _turns(kern)
        bound, by = _bound_ms(*work)
        row = {"ms": round(med, 4), "turns_min_max": [round(lo, 4), round(hi, 4)],
               "bound_ms": round(bound, 4), "bound_by": by, "share_of_bound": round(bound / med, 4),
               "plain_ms": round(_ms(plain, 5, 1), 4),
               "bitwise_repeatable": bool(torch.equal(got, again)),
               "max_abs_err": round(float((got.float() - want.float()).abs().max()), 5),
               "device_ms_by_kernel": device.get(name, {})}
        if chain is not None:
            row["library_chain_ms"] = round(_turns(chain)[0], 4)
        print(tag, name + ":", json.dumps(row), flush=True)
        s = sums.setdefault(fwd, {"ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0, "launches": 0})
        s["ms"] = round(s["ms"] + n * med, 4)
        s["bound_ms"] = round(s["bound_ms"] + n * bound, 4)
        s["plain_ms"] = round(s["plain_ms"] + n * row["plain_ms"], 4)
        s["launches"] += n
        if chain is not None:
            s["library_chain_ms"] = round(s.get("library_chain_ms", 0.0) + n * row["library_chain_ms"], 4)
    print(tag, "per forward:", json.dumps(sums), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
