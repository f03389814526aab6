"""vit_mlp at C = 1024 (HeAR's ViT-L MLP, hidden 4096) under two block
layouts of csrc/swin_mlp.cu's MlpCfg<1024>.

    python -m heart_murmur_detection_tpu_torch.bench.mlp_layouts [tag]

A layout is a block's output columns at C = 1024, HMDT_MLP_NB_1024: 512
(two blocks a panel, two W2 boxes of 128 rows a warpgroup, 160 accumulator
floats a consumer thread) or 256 (the committed layout: four blocks a
panel, each recomputing fc1, one W2 box a warpgroup, 96 floats), hidden
chunks of 128 in both. swin_mlp.cu is built by nvcc once a layout with
-DHMDT_MLP_NB_1024=<columns> into a temporary directory (both at once) and
launched through its C interface on the plan of ops/swin_plan.py with that
layout's output columns, at HeAR's token counts (B = 16 and 64 clips of 112
tokens). Prints, a line a layout and batch: the branch cosine against
vit_mlp_ref, the CUDA-event ms of a launch (median of 5 runs of 20), the
accumulator floats a consumer thread holds, and the ptxas registers and
spills of the C = 1024 instantiation. Needs a card.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

import torch

from ..ops import _build, swin_plan, vit
from ..ops.swin import _ptr
from .tower_rate import _ms

C, HIDDEN, NP = 1024, 4096, 112
LAYOUTS = (512, 256)  # output columns of a block at C = 1024


def _build_all(tmp: str) -> dict:
    """{columns: (ctypes library, ptxas line of the C = 1024 kernel)}."""
    nvcc, src = _build.find_nvcc(), os.path.join(_build.CSRC_DIR, "swin_mlp.cu")
    procs = {nb: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, f"-DHMDT_MLP_NB_1024={nb}", src, "-o",
         os.path.join(tmp, f"nb{nb}.so")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for nb in LAYOUTS}
    out = {}
    for nb, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on layout NB {nb}:\n{err[-4000:]}")
        lines = err.splitlines()
        at = next(i for i, ln in enumerate(lines) if "Compiling" in ln and "ILi1024E" in ln)
        usage = " ; ".join(x.strip().replace("ptxas info    : ", "") for x in lines[at + 1:at + 4]
                           if "registers" in x or "spill" in x)
        lib = ctypes.CDLL(os.path.join(tmp, f"nb{nb}.so"))
        lib.swin_mlp_launch.argtypes = _build._SIGNATURES["swin_mlp_launch"]
        lib.swin_mlp_launch.restype = ctypes.c_int
        out[nb] = (lib, usage)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tag = argv[0] if argv else "mlp_layouts"
    if not torch.cuda.is_available():
        print("mlp_layouts: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    f = lambda *s: torch.randn(*s, generator=g) * 0.03
    sd = {"norm1.weight": 1 + f(C), "norm1.bias": f(C), "attn.qkv.weight": f(3 * C, C),
          "attn.qkv.bias": f(3 * C), "attn.proj.weight": f(C, C), "attn.proj.bias": f(C),
          "norm2.weight": 1 + f(C), "norm2.bias": f(C), "mlp.fc1.weight": f(HIDDEN, C),
          "mlp.fc1.bias": f(HIDDEN), "mlp.fc2.weight": f(C, HIDDEN), "mlp.fc2.bias": f(C)}
    p = vit.prep_vit_block(sd, 16, torch.bfloat16, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_all(tmp)
        for B in (16, 64):
            x = (torch.randn(B, NP, C, generator=g) * 0.5).to(dev, torch.bfloat16)
            n = B * NP
            want = vit.vit_mlp_ref(x, p)
            for nb, (lib, usage) in libs.items():
                plan = swin_plan._mlp_plan(n, C, HIDDEN, sms, out_cols=nb)
                out = torch.empty_like(x)
                stream = torch.cuda.current_stream().cuda_stream

                def launch():
                    rc = lib.swin_mlp_launch(
                        _ptr(x), _ptr(out), _ptr(p.ln2_w), _ptr(p.ln2_b), _ptr(p.w_fc1),
                        _ptr(p.b_fc1), _ptr(p.w_fc2), _ptr(p.b_fc2), None, n, C, HIDDEN, 1,
                        plan.panel_rows, plan.ks, plan.stages, vit.LN_EPS, stream)
                    if rc:
                        raise RuntimeError(f"layout NB {nb}: launch returned {rc}")

                launch()
                torch.cuda.synchronize()
                a = (out.double() - x.double()).flatten()
                b = (want.double() - x.double()).flatten()
                cos = float(a @ b / (a.norm() * b.norm()))
                ms = statistics.median(_ms(launch, iters=20, warm=1) for _ in range(5))
                print(f"{tag} NB {nb} B={B} (ks {plan.ks}, stages {plan.stages}, "
                      f"{plan.acc_floats} accumulator floats): branch cos {cos:.7f}, {ms:.4f} ms "
                      f"a launch; ptxas {usage}; {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
