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


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tag = argv[0] if argv else "step"
    repeats = int(argv[1]) if len(argv) > 1 else 3
    if not torch.cuda.is_available():
        print("step_time: needs a CUDA card", file=sys.stderr)
        return 1
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
