"""Step-0 gradient drift of COLA continued pretraining: the train kernels, the
plain bf16 path and strict float32, leaf by leaf.

    python -m heart_murmur_detection_tpu_torch.bench.grad_drift              # on the card
    python -m heart_murmur_detection_tpu_torch.bench.grad_drift --device cpu --batch 2

For each seed and for dropout / DropPath on and off (deterministic), one
random-init full-width operaCT runs one forward and backward of the Cola
pair loss (models.cola.cola_loss) from the same weights, inputs and
generator on three paths: "kernel" (bf16, the CUDA train kernels), "plain"
(bf16, their plain versions with the same rounding points) and "f32"
(strict float32 autograd, TF32 off). It prints, for each pair of paths, the
losses, the cosine of the loss's cotangent at the projector outputs (z1, z2)
and, over every gradient leaf, the minimum and median cosine and the number
of leaves under 0.9999; then, leaf by leaf, the ratio of the kernel path's
distance (1 - cosine) from float32 to the plain path's. On the CPU the
"kernel" path runs the plain versions.
"""

from __future__ import annotations

import argparse
import copy
import sys

import numpy as np
import torch

from ..extract.registry import initialize_pretrained_model
from ..models.cola import cola_loss
from ..models.htsat_train_fused import cola_train_apply

BAR = 0.9999  # the step-0 leaf cosine asked of the kernel path vs the plain bf16 path


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    den = float(a.norm() * b.norm())
    return float(a @ b) / den if den > 0 else 1.0


def step0(base, x1, x2, impl: str, mm_dtype, deterministic: bool, dev):
    """Loss, cotangents at (z1 W^T, z2) and leaf gradients of one step."""
    model = copy.deepcopy(base)
    gen = torch.Generator(device=dev).manual_seed(5)
    (z1, z2), _ = cola_train_apply(model, x1, x2, gen, 0.1, mm_dtype,
                                   deterministic=deterministic, impl=impl)
    z1.retain_grad()
    z2.retain_grad()
    loss, _ = cola_loss(z1, z2)
    loss.backward()
    dz = torch.cat([z1.grad.flatten(), z2.grad.flatten()])
    grads = {q: w.grad.detach().clone() for q, w in model.named_parameters()}
    return float(loss.detach()), dz, grads


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--frames", type=int, default=251)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --device cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    paths = {"kernel": ("kernel", torch.bfloat16), "plain": ("plain", torch.bfloat16),
             "f32": ("autograd", torch.float32)}
    for seed in args.seeds:
        base = initialize_pretrained_model("operaCT", random_init=True, seed=seed).to(dev).train()
        g = torch.Generator().manual_seed(seed + 10)
        x1 = torch.randn(args.batch, args.frames, 64, generator=g) * 10 - 40
        x2 = x1 + torch.randn(args.batch, args.frames, 64, generator=g)
        x1, x2 = x1.to(dev), x2.to(dev)
        for det in (False, True):
            res = {k: step0(base, x1, x2, impl, mm, det, dev) for k, (impl, mm) in paths.items()}
            tag = f"seed {seed} {'deterministic' if det else 'dropout+DropPath'}"
            print(f"{tag}: loss " + " ".join(f"{k} {v[0]:.6f}" for k, v in res.items()))
            cos = {}
            for a, b in (("kernel", "plain"), ("kernel", "f32"), ("plain", "f32")):
                c = {q: _cos(res[a][2][q], res[b][2][q]) for q in res[b][2]}
                cos[a, b] = c
                lo = min(c, key=c.get)
                print(f"  {a} vs {b}: cotangent cos {_cos(res[a][1], res[b][1]):.7f}; leaves: min "
                      f"{c[lo]:.7f} ({lo.replace('encoder.encoder.htsat.', '')}), median "
                      f"{np.median(list(c.values())):.7f}, {sum(v < BAR for v in c.values())} of "
                      f"{len(c)} under {BAR}")
            kf, pf = cos["kernel", "f32"], cos["plain", "f32"]
            ratio = np.array([(1 - kf[q]) / max(1 - pf[q], 1e-12) for q in kf])
            print(f"  (1 - cos) from f32, kernel / plain: min {ratio.min():.3f} median "
                  f"{np.median(ratio):.3f} max {ratio.max():.3f}; leaves where kernel vs plain is "
                  f"under plain vs f32: {sum(cos['kernel', 'plain'][q] < pf[q] for q in pf)}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
