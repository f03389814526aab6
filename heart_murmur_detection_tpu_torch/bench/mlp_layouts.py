"""HeAR's ViT-L (C = 1024, 16 heads, hidden 4096) qkv, proj and MLP halves
on the card, each against its library calls, timed in turns.

    python -m heart_murmur_detection_tpu_torch.bench.mlp_layouts [tag] [--no-cluster]

Layouts:
  vit_mlp   rows     the committed route (csrc/vit_rows.cu: the LN2 row
                     pass, fc1 + b1 + GELU and fc2 + b2 + residual on the
                     wgmma GEMM core; ops/vit_plan.py's plan)
            cluster  bench/vit_mlp_cluster.cu (built here by nvcc, not in
                     the port's library): one launch, a cluster of four
                     blocks a 64-row panel passing fc1's GELU chunks
                     through distributed shared memory
            nowait   the same built with -DHMDT_CL_EXCHANGE=0: no wait,
                     arrival or copy of the exchange (a timing probe of
                     what the cluster synchronisation costs; its output is
                     not checked); --no-cluster skips both
            chain    the library chain layer_norm, addmm, gelu, addmm, add
  vit_qkv   rows     the committed route (the LN1 row pass, then the GEMM
                     with the head-major epilogue)
            addmm    torch.addmm on the LN1 output
  vit_proj  kernel   csrc/vit_proj.cu;  addmm  torch.addmm + the residual

at B = 1, 16 and 64 clips of 112 tokens (97 real). Prints, a line each:
the cosine of every kernel layout's output (the MLP's branch out - x)
against its plain version (ops/vit.py vit_mlp_ref, vit_qkv_ref,
vit_proj_ref), whether two launches of each kernel layout agree bitwise,
and each layout's ms of a launch: a CUDA graph of 20 launches replayed
and timed with CUDA events (no host work in the reading), the median over
5 turns (the layouts in turns, forward then backward order), beside the
launch's bound. `compare` is what chip_smoke.py's phase 22 runs. Needs a
card.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

import torch

from ..ops import _build, vit
from ..ops.swin import _check_launch, _cuda_stream, _ptr
from .swin_fwd_time import mlp_chain
from .tower_rate import _ms

C, HEADS, HIDDEN, NP, N_REAL = 1024, 16, 4096, 112, 97
BATCHES = (1, 16, 64)
HBM_BPS, BF16_FLOPS = 3.35e12, 989e12  # H100 SXM (NVIDIA data sheet)


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def bounds(B: int) -> dict:
    """ms of each launch's bound: the larger of its bytes (each input read
    once, each output written once) over the HBM rate and its operations
    over the dense bf16 peak."""
    n = B * NP
    work = {"vit_qkv": (2 * n * C + 2 * 3 * C * C + 2 * 3 * n * C, 6 * n * C * C),
            "vit_proj": (2 * 3 * n * C + 2 * C * C, 2 * n * C * C),
            "vit_mlp": (2 * 2 * n * C + 2 * 2 * C * HIDDEN, 4 * n * C * HIDDEN)}
    return {k: 1e3 * max(b / HBM_BPS, o / BF16_FLOPS) for k, (b, o) in work.items()}


def block_params(dev, seed: int = 0) -> vit.VitBlockParams:
    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g) * 0.03
    sd = {"norm1.weight": 1 + f(C), "norm1.bias": f(C), "attn.qkv.weight": f(3 * C, C),
          "attn.qkv.bias": f(3 * C), "attn.proj.weight": f(C, C), "attn.proj.bias": f(C),
          "norm2.weight": 1 + f(C), "norm2.bias": f(C), "mlp.fc1.weight": f(HIDDEN, C),
          "mlp.fc1.bias": f(HIDDEN), "mlp.fc2.weight": f(C, HIDDEN), "mlp.fc2.bias": f(C)}
    return vit.prep_vit_block(sd, HEADS, torch.bfloat16, dev)


CLUSTER_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vit_mlp_cluster.cu")
CLUSTER_VARIANTS = {"cluster": [], "nowait": ["-DHMDT_CL_EXCHANGE=0"]}


def build_cluster(tmp: str):
    """bench/vit_mlp_cluster.cu, each variant by its own nvcc, started
    together: ({variant: ctypes library}, {variant: ptxas registers and
    spills})."""
    nvcc = _build.find_nvcc()
    procs = {}
    for name, flags in CLUSTER_VARIANTS.items():
        so = os.path.join(tmp, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, *flags, CLUSTER_SRC, "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs, usage = {}, {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the cluster layout ({name}):\n{err[-4000:]}")
        usage[name] = " ; ".join(x.strip().replace("ptxas info    : ", "")
                                 for x in err.splitlines() if "registers" in x or "spill" in x)
        lib = ctypes.CDLL(so)
        lib.vit_mlp_cluster_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_void_p]
        lib.vit_mlp_cluster_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs, usage


def cluster_mlp(lib, x: torch.Tensor, p: vit.VitBlockParams) -> torch.Tensor:
    """The MLP half on the cluster layout (x (B, Np, 1024) bf16 on the
    card)."""
    out = torch.empty_like(x)
    rc = lib.vit_mlp_cluster_launch(
        _ptr(x), _ptr(out), _ptr(p.ln2_w), _ptr(p.ln2_b), _ptr(p.w_fc1), _ptr(p.b_fc1),
        _ptr(p.w_fc2), _ptr(p.b_fc2), x.shape[0] * x.shape[1], C, HIDDEN, vit.LN_EPS,
        _cuda_stream(x))
    _check_launch("vit_mlp_cluster", rc)
    return out


def graph_ms(fn, iters: int = 20) -> float:
    """ms of one call of fn: a CUDA graph of `iters` calls, replayed once
    after a warm replay, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    g.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _turns(fns: dict, turns: int, iters: int) -> dict:
    """{name: median ms of a launch} over `turns` turns, the names in order,
    then in reverse order, and so on."""
    got = {k: [] for k in fns}
    names = list(fns)
    for t in range(turns):
        for k in (names if t % 2 == 0 else names[::-1]):
            got[k].append(graph_ms(fns[k], iters))
    return {k: statistics.median(v) for k, v in got.items()}


def _check(fns: dict, want: torch.Tensor, base) -> dict:
    """The cosine to the plain output (of the branch where base is given)
    and the bitwise repeat of each kernel layout."""
    cos, same, err = {}, {}, {}
    for k, f in fns.items():
        a, b = f(), f()
        torch.cuda.synchronize()
        cos[k] = _cos(a - base, want - base) if base is not None else _cos(a, want)
        same[k] = torch.equal(a, b)
        err[k] = float((a.float() - want.float()).abs().max())
    return {"cos": cos, "same": same, "max_abs_err": err}


def compare(B: int, p: vit.VitBlockParams, cluster: dict = None, turns: int = 5,
            iters: int = 20, seed: int = 0) -> dict:
    """Every layout of the three halves at B clips on p's card: {half:
    {"cos": {layout: cosine}, "same": {layout: bool}, "max_abs_err":
    {layout: float}, "ms": {layout: median ms}, "plain_ms": ms of the plain
    version (CUDA events around 3 eager calls)}} and "bound_ms": {half: ms}.
    cluster: build_cluster's libraries, or None to leave that layout out.
    The caller holds the bars."""
    dev = p.w_qkv.device
    g = torch.Generator().manual_seed(seed + B)
    x = (torch.randn(B, NP, C, generator=g) * 0.5).to(dev, torch.bfloat16)
    x[:, N_REAL:] = 0.0  # the padded rows of a first block
    out = {"bound_ms": bounds(B)}

    # the MLP half
    mlp = {"rows": lambda: vit.vit_mlp(x, p)}
    if cluster:
        mlp["cluster"] = lambda: cluster_mlp(cluster["cluster"], x, p)
    out["vit_mlp"] = _check(mlp, vit.vit_mlp_ref(x, p), x)
    out["vit_mlp"]["plain_ms"] = _ms(lambda: vit.vit_mlp_ref(x, p), iters=3, warm=1)
    mlp["chain"] = mlp_chain(x, p, vit.LN_EPS)
    if cluster:
        mlp["nowait"] = lambda: cluster_mlp(cluster["nowait"], x, p)
    out["vit_mlp"]["ms"] = _turns(mlp, turns, iters)

    # the qkv part of the attention half, and its LN1 rows
    want = vit.vit_qkv_ref(x, p)
    out["vit_qkv"] = _check({"rows": lambda: vit.vit_qkv(x, p)}, want, None)
    ln1 = vit.vit_qkv(x, p, return_ln=True)[1]
    out["vit_qkv"]["cos"]["ln1"] = _cos(ln1, vit.ln1_rows(x, p))
    out["vit_qkv"]["plain_ms"] = _ms(lambda: vit.vit_qkv_ref(x, p), iters=3, warm=1)
    h, bq = vit.ln1_rows(x, p), p.b_qkv.to(torch.bfloat16)
    out["vit_qkv"]["ms"] = _turns({"rows": lambda: vit.vit_qkv(x, p),
                                   "addmm": lambda: torch.addmm(bq, h, p.w_qkv.t())},
                                  turns, iters)

    # proj and the residual, on the plain attention output
    o = vit.vit_attn_core_ref(want, p, N_REAL, "fast")
    o2, x2, bp = o.reshape(-1, C), x.reshape(-1, C), p.b_proj.to(torch.bfloat16)
    out["vit_proj"] = _check({"kernel": lambda: vit.vit_proj(o, x, p)}, vit.vit_proj_ref(o, x, p),
                             x)
    out["vit_proj"]["plain_ms"] = _ms(lambda: vit.vit_proj_ref(o, x, p), iters=3, warm=1)
    out["vit_proj"]["ms"] = _turns({"kernel": lambda: vit.vit_proj(o, x, p),
                                    "addmm": lambda: torch.addmm(bp, o2, p.w_proj.t()).add_(x2)},
                                   turns, iters)
    return out


def report(tag: str, B: int, r: dict, smi: str) -> list:
    """The printed lines of one compare() result."""
    lines = []
    for half in ("vit_mlp", "vit_qkv", "vit_proj"):
        h = r[half]
        cos = ", ".join(f"{k} {v:.7f}" for k, v in h["cos"].items())
        same = ", ".join(f"{k} {v}" for k, v in h["same"].items())
        err = ", ".join(f"{k} {v:.4g}" for k, v in h["max_abs_err"].items())
        ms = ", ".join(f"{k} {v:.4f}" for k, v in h["ms"].items())
        lines.append(f"{tag} {half} C={C} B={B}: cosine vs plain {cos}; bitwise repeatable "
                     f"{same}; max|d| {err}; ms a launch (CUDA-graph replay, median over turns) "
                     f"{ms}; bound {r['bound_ms'][half]:.4f} ms; plain version "
                     f"{h['plain_ms']:.4f} ms (eager); {smi}")
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    with_cluster = "--no-cluster" not in argv
    argv = [a for a in argv if a != "--no-cluster"]
    tag = argv[0] if argv else "mlp_layouts"
    if not torch.cuda.is_available():
        print("mlp_layouts: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    p = block_params(torch.device("cuda"))
    with tempfile.TemporaryDirectory() as tmp:
        cluster = None
        if with_cluster:
            cluster, usage = build_cluster(tmp)
            for name, u in usage.items():
                print(f"{tag} {name} ptxas: {u}", flush=True)
        for B in BATCHES:
            for ln in report(tag, B, compare(B, p, cluster), smi):
                print(ln, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
