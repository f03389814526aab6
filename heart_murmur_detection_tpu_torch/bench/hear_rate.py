"""Device-resident throughput of the HeAR tower (ViT-L/16 over mel-PCEN), and
a profile of one batch.

    python -m heart_murmur_detection_tpu_torch.bench.hear_rate [tag] [repeats] [--profile]

Random weights from seed 0 (the registry's random_init), B=64 clips of 2 s
of noise already on the card as float32 waveforms, the extraction flow of
models/vit_fused.py::hear_forward_fused (mel-PCEN in float32, the 24 blocks
on the kernels of ops/vit.py, fast softmax). Each path is warmed up, then
timed by CUDA events over 10 batches: the kernel path and the plain bf16
path (the kernels' plain versions) in turns (kernel, plain, plain, kernel),
`repeats` times (default 1). Prints one JSON line of ms a batch and clips a
second, prefixed by `tag`. With --profile, a fresh child process (the card
machine's profiler drops device records once a process has lived some tens
of seconds) prints one JSON line: the device ms of one batch by kernel, the
frontend's steps (the DFT products, the mel product, PCEN, the resize), the
glue (the rest: framing, min-max, patch embed, pads, the final LayerNorm
and the pooler) and the idle share against the unprofiled batch. Needs a
card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

from .tower_rate import _ms

B = 64
KERNELS = (("vit_qkv", "vit_qkv_kernel"), ("vit_attn", "vit_attn_kernel"),
           ("vit_proj", "vit_proj_kernel"), ("vit_mlp", "swin_mlp_kernel"))


def setup(batch: int = B, seed: int = 0):
    """((batch, 32000) float32 waveforms on the card, the kernel path's batch
    function, the plain bf16 path's), on the registry's random weights."""
    from ..extract.registry import initialize_pretrained_model
    from ..models.vit_fused import hear_forward_fused

    model = initialize_pretrained_model("hear", random_init=True, seed=seed).cuda()
    g = torch.Generator().manual_seed(seed + 2)
    wav = (torch.randn(batch, 32000, generator=g) * 0.2).cuda()
    kern = lambda: hear_forward_fused(model, wav, torch.bfloat16, True)
    plain = lambda: hear_forward_fused(model, wav, torch.bfloat16, True, impl="plain")
    return wav, kern, plain


def rates(kern, plain, repeats: int = 1, batch: int = B) -> dict:
    """ms a batch of each path, in turns (kernel, plain, plain, kernel)."""
    out = {"kernel_ms": [], "plain_ms": []}
    for _ in range(repeats):
        for name in ("kernel_ms", "plain_ms", "plain_ms", "kernel_ms"):
            fn = kern if name == "kernel_ms" else plain
            out[name].append(round(_ms(fn, 10 if fn is kern else 3, 2 if fn is kern else 1), 4))
    for k in ("kernel", "plain"):
        ms = sorted(out[f"{k}_ms"])[len(out[f"{k}_ms"]) // 2]
        out[f"{k}_clips_per_s"] = round(batch * 1000 / ms, 1)
    return out


def _device_rows(fn, n: int = 2):
    """{kernel name: device ms a call} over n calls of fn."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        rows[e.key] = rows.get(e.key, 0.0) + (e.self_cuda_time_total if us is None else us) / 1e3 / n
    return rows


def profile_child() -> int:
    """The child: one JSON line of one kernel-path batch's device time."""
    from ..audio import hear_frontend as hf
    from ..audio.dsp import frame_signal

    wav, kern, _ = setup()
    with torch.no_grad():
        wall = _ms(kern, 5, 2)
        rows = _device_rows(kern)
        kernels = {k: sum(v for key, v in rows.items() if sym in key) for k, sym in KERNELS}
        busy = sum(rows.values())
        # the frontend's steps, each alone on the batch's own intermediates
        x = wav - wav.amin(1, keepdim=True)
        x = x / (x.amax(1, keepdim=True) + 1e-8) * 2.0 - 1.0
        frames = frame_signal(x, hf.FRAME, hf.HOP, 200)
        cos, sin = hf._on(wav.device, "cos", hf.FRAME), hf._on(wav.device, "sin", hf.FRAME)
        re, im = frames @ cos, frames @ sin
        power = re * re + im * im
        melm = hf._on(wav.device, "mel")
        mel = power @ melm
        p = hf.pcen(mel)
        steps = {"dft": lambda: (frames @ cos, frames @ sin),
                 "mel": lambda: power @ melm,
                 "pcen": lambda: hf.pcen(mel),
                 "resize": lambda: hf.resize_bilinear_tf(p, *hf.OUT_HW),
                 "frontend_whole": lambda: hf.hear_preprocess(wav)}
        front = {k: round(sum(_device_rows(fn).values()), 4) for k, fn in steps.items()}
    glue = busy - sum(kernels.values()) - front["frontend_whole"]
    print(json.dumps({"batch": B, "wall_ms": round(wall, 4), "device_busy_ms": round(busy, 4),
                      "idle_share": round(1 - busy / wall, 4),
                      "kernels_ms": {k: round(v, 4) for k, v in kernels.items()},
                      "frontend_ms": front, "glue_ms": round(glue, 4)}))
    return 0


def profile_in_child(module: str = __spec__.name) -> dict:
    """The last JSON line of `python -m <module> --profile-child` (this
    module's profile_child by default), from a fresh process."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    child = subprocess.run([sys.executable, "-m", module, "--profile-child"],
                           capture_output=True, text=True, cwd=root)
    lines = child.stdout.strip().splitlines()
    if child.returncode or not lines:
        raise RuntimeError(f"{module} profile child failed: {child.stderr[-2000:]}")
    return json.loads(lines[-1])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("hear_rate: needs a CUDA card", file=sys.stderr)
        return 1
    if argv[:1] == ["--profile-child"]:
        return profile_child()
    want_profile = "--profile" in argv
    argv = [a for a in argv if a != "--profile"]
    tag = argv[0] if argv else "hear_rate"
    repeats = int(argv[1]) if len(argv) > 1 else 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    _, kern, plain = setup()
    with torch.no_grad():
        out = {"card": smi, **rates(kern, plain, repeats)}
    print(tag, json.dumps(out), flush=True)
    if want_profile:
        print(tag, "profile:", json.dumps(profile_in_child()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
