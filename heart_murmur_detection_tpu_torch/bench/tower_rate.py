"""Device-resident throughput of the three extraction towers on the kernels:
the batches of chip_smoke.py's phases 6 and 13.

    python -m heart_murmur_detection_tpu_torch.bench.tower_rate [tag] [repeats]

operaCT (HTS-AT, 768-d latent) on B=64 10-s clips, operaGT (ViT-S) on B=64
8.18-s chunks and audiomae (ViT-B/16) on B=32 10-s chunks: random weights
from seed 0, int16 noise already on the card, the FeatureExtractor's
compiled batch function (wire decode, log-mel or fbank, the encoder on the
kernels, pooling), the stable softmax. Each batch is warmed up twice, then
timed by CUDA events over 10 batches, `repeats` times (default 3). Prints
one JSON line of ms a batch and clips (chunks) a second, the median and
every reading, prefixed by `tag`; run it once per source tree (parent,
change, change, parent) to compare two versions on one card. Needs a card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

from ..extract.extract import FeatureExtractor

# (tower, batch, seconds of audio a clip)
TOWERS = (("operaCT", 64, 10.0), ("operaGT", 64, 8.18), ("audiomae", 32, 10.0))


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


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tag = argv[0] if argv else "tower_rate"
    repeats = int(argv[1]) if len(argv) > 1 else 3
    if not torch.cuda.is_available():
        print("tower_rate: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"card": smi}
    for tower, B, sec in TOWERS:
        kw = dict(input_sec=sec, batch_size=B) if tower != "operaCT" else dict(dim=768)
        ex = FeatureExtractor(tower, random_init=True, seed=0, device="cuda", **kw)
        n = int(sec * 16000)
        npad = (n + 511) // 512 * 512
        g = torch.Generator().manual_seed(2)
        wav = torch.zeros(B, npad, dtype=torch.int16)
        wav[:, :n] = (torch.randn(B, n, generator=g) * 3000).to(torch.int16)
        wav, lengths = wav.to("cuda"), torch.full((B,), n, dtype=torch.int32, device="cuda")
        fn = ex._build(fast_softmax=False) if tower != "operaCT" else ex._build()
        ms = [_ms(lambda: fn(wav, lengths)) for _ in range(repeats)]
        med = statistics.median(ms)
        out[tower] = {"batch": B, "ms": round(med, 4), "per_s": round(B * 1000 / med, 1),
                      "ms_readings": [round(m, 4) for m in ms]}
        del ex, fn
        torch.cuda.empty_cache()
    print(tag, json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
