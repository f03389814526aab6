"""Step times of the training steps: a COLA continued-pretraining step of
operaCT and an operaCT fine-tuning step (the swin kernels only), and an
Audio-MAE continued-pretraining step (the ViT training kernels).

    python -m heart_murmur_detection_tpu_torch.bench.step_time [tag] [repeats]

The steps of chip_smoke.py's phases 8, 15 and 21 at their batches, on the
kernels (impl="kernel", bf16): COLA at B=64 pairs of 251-frame crops (the
circor crop) of random 64-mel clips, operaCT fine-tuning at B=64 first
windows of 256 x 64 with TF32 off (strict_f32, as phase 21 times it),
Audio-MAE at B=64 random 1024 x 128 fbank clips, mask ratio 0.7.
Random weights from seed 0, data from numpy seed 1. Each step is warmed up
twice, then timed by CUDA events over 5 steps, `repeats` times (default
3). Prints one JSON line of ms a step, prefixed by `tag`; run it once per
source tree (parent, change, change, parent) to compare two versions on one
card. Needs a card.

    python -m heart_murmur_detection_tpu_torch.bench.step_time [tag] [repeats] --profile

also profiles a COLA step and an Audio-MAE CP step in a fresh child process
(the card machine's profiler drops device records once a process has lived
some tens of seconds): the device ms a step by kernel group (the port's
kernels by name, the backward kernels' swin_*_bwd_ / vit_attn_bwd_ prefixes
first), everything else, the idle share against the unprofiled step, and
the top operations of everything else by device time.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

B = 64
COLA_CROP = 251  # pretrain/data.py OPTIMAL_MAX_LEN_COLA["circor"]
FT_FRAMES = 256  # the 8.18-s first window of operaCT fine-tuning


def _ms(fn, iters: int = 5, warm: int = 2) -> float:
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


def cola_step(rng: np.random.Generator, dev: str = "cuda", batch: int = B):
    """A closure running one COLA step of operaCT on the kernels (on the
    CPU: their plain versions)."""
    from ..extract.registry import initialize_pretrained_model
    from ..pretrain import cola_training as ct
    from ..pretrain import steps
    from ..pretrain.data import cola_views_np

    model = initialize_pretrained_model("operaCT", random_init=True, seed=0).to(dev).train()
    opt = steps.adam_with_epoch_decay(list(model.parameters()), 5)
    clips = [rng.standard_normal((int(rng.integers(300, 800)), 64)).astype(np.float32)
             for _ in range(batch)]
    pairs = [cola_views_np(rng, c, COLA_CROP) for c in clips]
    x1, x2 = (torch.from_numpy(np.stack([p[i] for p in pairs])).to(dev) for i in (0, 1))
    gen = torch.Generator(device=dev).manual_seed(0)
    return lambda: ct.train_step(model, opt, x1, x2, gen, torch.bfloat16, "kernel", 0.1)


def finetune_step(rng: np.random.Generator, dev: str = "cuda", batch: int = B):
    """A closure running one operaCT fine-tuning step on the kernels (on
    the CPU: their plain versions)."""
    from ..train import finetune as ft
    from ..train.linear_eval import ClippedAdam

    model = ft.EncoderClassifier("htsat", 3, "linear", 768,
                                 generator=torch.Generator().manual_seed(0)).to(dev)
    opt = ClippedAdam(model.parameters(), 3, 1e-4, 0.99, 1.0)
    xb = torch.from_numpy(rng.standard_normal((batch, FT_FRAMES, 64)).astype(np.float32)).to(dev)
    yb = torch.from_numpy(rng.integers(0, 3, batch)).to(dev)
    valid, cw = torch.ones(batch, device=dev), torch.ones(3, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    return lambda: ft.train_step(model, opt, xb, yb, valid, cw, gen, torch.bfloat16, "kernel",
                                 1e-4)


def audiomae_step(rng: np.random.Generator, dev: str = "cuda", batch: int = B):
    """A closure running one Audio-MAE CP step (ViT-B/16 encoder on the
    kernels, the decoder in plain torch; on the CPU: the plain versions)."""
    from ..models import vit_mae
    from ..pretrain import steps

    model = vit_mae.MaskedAutoencoderViT(vit_mae.audiomae_base_config(mask_ratio=0.7),
                                         decoder=True)
    vit_mae.init_weights(model, torch.Generator().manual_seed(0))
    model.to(dev).train()
    opt = steps.adam_with_epoch_decay(list(model.parameters()), 5)
    x = torch.from_numpy(rng.standard_normal((batch, 1024, 128)).astype(np.float32)).to(dev)
    noise = torch.rand(batch, 512, generator=torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    return lambda: steps.mae_train_step(model, opt, x, torch.bfloat16, "kernel", noise)


# kernel groups by symbol, first match wins (vit_mlp / vit_mlp_bwd run the
# swin_mlp kernels: an Audio-MAE step's swin_mlp* groups are the ViT's)
GROUPS = (("swin_attn_bwd", "swin_attn_bwd_"), ("swin_mlp_bwd", "swin_mlp_bwd_"),
          ("vit_attn_bwd", "vit_attn_bwd_"), ("swin_wgrad", "swin_wgrad_kernel"),
          ("swin_reduce", "swin_reduce_kernel"), ("swin_attn", "swin_attn_kernel"),
          ("swin_mlp", "swin_mlp_kernel"), ("vit_qkv", "vit_qkv_kernel"),
          ("vit_attn", "vit_attn_kernel"), ("vit_proj", "vit_proj_kernel"))
TOP_OTHER = 12


def profile_child() -> int:
    """The child: one JSON line, per step, of the device ms a step by group,
    the rest, the top operations of the rest and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(1)
    out = {}
    for name, make in (("cola", cola_step), ("audiomae_cp", audiomae_step)):
        step = make(rng)
        wall = _ms(step, 3, 2)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                step()
            torch.cuda.synchronize()
        groups, other = {g: 0.0 for g, _ in GROUPS}, {}
        for e in prof.key_averages():
            if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                continue
            us = getattr(e, "self_device_time_total", None)
            ms = (e.self_cuda_time_total if us is None else us) / 1e3 / 2
            g = next((g for g, sym in GROUPS if sym in e.key), None)
            if g is None:
                other[e.key[:90]] = other.get(e.key[:90], 0.0) + ms
            else:
                groups[g] += ms
        if name == "audiomae_cp":
            groups = {k.replace("swin_mlp", "vit_mlp"): v for k, v in groups.items()}
        busy = sum(groups.values()) + sum(other.values())
        top = sorted(other.items(), key=lambda kv: -kv[1])[:TOP_OTHER]
        out[name] = {"wall_ms": round(wall, 3), "device_busy_ms": round(busy, 3),
                     "idle_share": round(1 - busy / wall, 4),
                     "kernels_ms": {k: round(v, 3) for k, v in groups.items() if v},
                     "other_ms": round(sum(other.values()), 3),
                     "other_top_ms": [[k, round(v, 3)] for k, v in top]}
        del step
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("step_time: needs a CUDA card", file=sys.stderr)
        return 1
    if argv[:1] == ["--profile-child"]:
        return profile_child()
    want_profile = "--profile" in argv
    argv = [a for a in argv if a != "--profile"]
    tag = argv[0] if argv else "step"
    repeats = int(argv[1]) if len(argv) > 1 else 3
    from ..utils.precision import strict_f32

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    rng = np.random.default_rng(1)
    out = {"card": smi}
    step = cola_step(rng)
    out["cola_ms"] = [round(_ms(step), 3) for _ in range(repeats)]
    del step
    torch.cuda.empty_cache()
    with strict_f32():
        step = finetune_step(rng)
        out["finetune_operaCT_ms"] = [round(_ms(step), 3) for _ in range(repeats)]
    del step
    torch.cuda.empty_cache()
    step = audiomae_step(rng)
    out["audiomae_cp_ms"] = [round(_ms(step), 3) for _ in range(repeats)]
    print(tag, json.dumps(out), flush=True)
    if want_profile:
        child = subprocess.run([sys.executable, "-m", __spec__.name, "--profile-child"],
                               capture_output=True, text=True)
        lines = child.stdout.strip().splitlines()
        if child.returncode or not lines:
            print(tag, "profile child failed:", child.stderr[-2000:], flush=True)
            return 1
        print(tag, "profile:", lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
