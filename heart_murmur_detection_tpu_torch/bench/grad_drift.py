"""Step-0 gradient drift of continued pretraining: the train kernels, the
plain bf16 path and strict float32, leaf by leaf.

    python -m heart_murmur_detection_tpu_torch.bench.grad_drift              # COLA, on the card
    python -m heart_murmur_detection_tpu_torch.bench.grad_drift --method audiomae
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

--method audiomae | mae: the same readings for MAE continued pretraining of
a random-init full-width Audio-MAE (ViT-B/16 and its decoder, 1024 x 128
fbank inputs) or OPERA-GT MAE (ViT-S, 256 x 64 mel inputs): one forward and
backward of models.mae_train_fused.mae_train_loss_fused from the same
weights, inputs and masking noise (no dropout, so one reading a seed; the
cotangent is taken at the decoder's predictions). The meta-MLP output
biases of the decoder, whose exact gradient is 0, are left out.
"""

from __future__ import annotations

import argparse
import copy
import sys

import numpy as np
import torch

from ..extract.registry import initialize_pretrained_model
from ..models import vit_mae
from ..models.cola import cola_loss
from ..models.htsat_train_fused import cola_train_apply
from ..models.mae_train_fused import mae_encode_train_fused

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


def step0_mae(base, x, noise, impl: str, mm_dtype):
    """Loss, cotangent at the decoder's predictions and leaf gradients of
    one MAE step (ZERO_GRAD leaves left out)."""
    model = copy.deepcopy(base)
    h, mask, ids = mae_encode_train_fused(model, x, noise, None, mm_dtype, impl)
    pred = model.forward_decoder(h, ids, mm_dtype)
    pred.retain_grad()
    loss = model.masked_loss(x, pred, mask)
    loss.backward()
    grads = {q: w.grad.detach().clone() for q, w in model.named_parameters()
             if not q.endswith(ZERO_GRAD)}
    return float(loss.detach()), pred.grad.flatten(), grads


ZERO_GRAD = "attn.meta_mlp.fc2.bias"  # a per-head logit shift: exact gradient 0


def _report(tag, res):
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--method", choices=("cola", "audiomae", "mae"), default="cola")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--frames", type=int, default=None,
                    help="frames a clip (default: 251 cola, 1024 audiomae, 256 mae)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --device cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    paths = {"kernel": ("kernel", torch.bfloat16), "plain": ("plain", torch.bfloat16),
             "f32": ("autograd", torch.float32)}
    if args.method != "cola":
        cfg = (vit_mae.audiomae_base_config if args.method == "audiomae"
               else vit_mae.mae_vit_small_config)(mask_ratio=0.7)
        T = args.frames or cfg.img_size[0]
        F = cfg.img_size[1]
        L = (T // cfg.patch_size) * (F // cfg.patch_size)
        for seed in args.seeds:
            base = vit_mae.MaskedAutoencoderViT(cfg, decoder=True)
            vit_mae.init_weights(base, torch.Generator().manual_seed(seed))
            base.to(dev).train()
            g = torch.Generator().manual_seed(seed + 10)
            x = (torch.randn(args.batch, T, F, generator=g) * 10 - 40).to(dev)
            noise = torch.rand(args.batch, L, generator=g).to(dev)
            res = {k: step0_mae(base, x, noise, impl, mm) for k, (impl, mm) in paths.items()}
            _report(f"{args.method} seed {seed} B={args.batch} T={T}", res)
        return 0
    for seed in args.seeds:
        base = initialize_pretrained_model("operaCT", random_init=True, seed=seed).to(dev).train()
        g = torch.Generator().manual_seed(seed + 10)
        x1 = torch.randn(args.batch, args.frames or 251, 64, generator=g) * 10 - 40
        x2 = x1 + torch.randn(args.batch, args.frames or 251, 64, generator=g)
        x1, x2 = x1.to(dev), x2.to(dev)
        for det in (False, True):
            res = {k: step0(base, x1, x2, impl, mm, det, dev) for k, (impl, mm) in paths.items()}
            _report(f"seed {seed} {'deterministic' if det else 'dropout+DropPath'}", res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
