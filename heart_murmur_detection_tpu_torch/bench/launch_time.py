"""What parallel.launch itself costs: seconds from the call to rank 0's
result for a rank function that only builds its mesh, with the arguments
chip_smoke.py's phases 31, 32 and 34 hand it (none, or a path string).

    python -m heart_murmur_detection_tpu_torch.bench.launch_time [tag] [turns] [--device cpu]

Cases: NCCL at world 1 and two gloo ranks on the card (phase 31), four
gloo ranks as dp2 x tp2 (phases 32 and 34). Prints one JSON line: the
card, and for each case the seconds of every launch in order and their
median. To compare two versions of parallel/launch.py, copy this module
into the other tree's bench/ and run it from each tree in turns.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from ..parallel import launch

# (name, ranks, backend, tp, arguments)
CASES = [("nccl1", 1, "nccl", 1, ()), ("gloo2", 2, "gloo", 1, ()),
         ("gloo4_tp2", 4, "gloo", 2, ("corpus-root",))]


def _rank(mesh, *args):
    return len(args)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--device" in argv and argv[argv.index("--device") + 1] == "cpu" else "cuda"
    argv = [a for a in argv if a not in ("--device", "cpu", "cuda")]
    tag = argv[0] if argv else "launch_time"
    turns = int(argv[1]) if len(argv) > 1 else 2
    if device == "cuda" and not torch.cuda.is_available():
        print("launch_time: needs a CUDA card (or --device cpu)", file=sys.stderr)
        return 1
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
           if device == "cuda" else "cpu")
    out = {"tag": tag, "card": smi}
    for name, n, backend, tp, args in CASES:
        if device == "cpu" and backend == "nccl":
            continue
        secs = []
        for _ in range(turns):
            t0 = time.perf_counter()
            got = launch(_rank, n, *args, backend=backend, device=device, tp=tp)
            secs.append(round(time.perf_counter() - t0, 3))
            assert got == len(args), got
        out[name] = {"s": secs, "median_s": statistics.median(secs)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
