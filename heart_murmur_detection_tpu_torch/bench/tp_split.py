"""How far a split batch moves the bf16 COLA step: the full-width operaCT's
step 0 (bench/dp_scale.py::cola_steps, DropPath and dropout off) on one
device on the plain bf16 route, on two gloo data ranks, and on dp2 x tp2
gloo ranks with megatron placement (parallel/tensor.py), each against the
one-device plain step: the loss's relative difference, the least
gradient-leaf cosine and the global norm ratio (bench/dp_scale.py::
grad_report), one JSON line a comparison.

    python -m heart_murmur_detection_tpu_torch.bench.tp_split [tag] [--batch 8] [--device cpu]

The same weights (seed 0) and pairs of 251-frame crops (numpy seed 50) in
every run; the ranks share the device (gloo). It separates what the tensor
axis moves from what splitting the batch over data ranks moves in the bf16
flow (chip_smoke.py phase 32 holds its bf16 megatron step at phase 31's
shape, B=64, for this reason).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def _pairs(B: int):
    r = np.random.default_rng(50)
    mel = lambda: (r.standard_normal((B, 251, 64)) * 10 - 40).astype(np.float32)
    return [(mel(), mel())]


def step0(mesh, B: int, device: str, megatron: bool):
    """The plain bf16 route's step-0 loss and summed gradients."""
    from .dp_scale import cola_steps

    dev = mesh.device if mesh is not None else torch.device(device)
    out = cola_steps(mesh, dev, _pairs(B), "plain", False, 0, mm_dtype=torch.bfloat16,
                     megatron=megatron)
    return out["losses"][0], out["grads"]


def main(argv=None):
    from ..parallel.launch import launch
    from .dp_scale import grad_report

    ap = argparse.ArgumentParser()
    ap.add_argument("tag", nargs="?", default="tp_split")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    one = step0(None, a.batch, a.device, False)
    runs = {"dp2": launch(step0, 2, a.batch, a.device, False, backend="gloo", device=a.device),
            "dp2xtp2": launch(step0, 4, a.batch, a.device, True, backend="gloo",
                              device=a.device, tp=2)}
    runs["dp2xtp2 vs dp2"] = runs["dp2xtp2"]
    for name, (loss, grads) in runs.items():
        want = runs["dp2"] if name == "dp2xtp2 vs dp2" else one
        r = grad_report(grads, want[1], 0.9995)
        print(json.dumps({"tag": a.tag, "batch": a.batch, "device": a.device, "run": name,
                          "loss": loss, "reference_loss": want[0],
                          "loss_rel_diff": abs(loss - want[0]) / abs(want[0]),
                          "min_leaf_cosine": r["min_leaf_cosine"], "min_leaf": r["min_leaf"],
                          "norm_ratio": r["norm_ratio"]}), flush=True)


if __name__ == "__main__":
    main()
