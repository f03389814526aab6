"""Data-parallel COLA step times over NCCL, one card a rank, and the step-0
gradients of a world against one device; with the helpers that
chip_smoke.py's phase 31 shares (cola_steps, grad_report).

    python -m heart_murmur_detection_tpu_torch.bench.dp_scale [tag] [max_world] [--gloo]

For each world n in 1, 2, 4, ... up to max_world (default: every card of
the machine), n NCCL ranks (parallel/launch.py) run the full-width operaCT
COLA step on the train kernels (bf16, DropPath and dropout off) at
  - a global batch of 64 pairs (64 / n rows a rank: strong scaling), and
  - 64 pairs a rank (weak scaling),
each warmed up twice, then timed by CUDA events over 5 steps on rank 0
(the steps hold every rank in the gradient all-reduce). Pairs of 251-frame
crops of random 64-mel clips from numpy seed 1, weights from seed 0. The
largest world's step-0 summed gradients are compared with one device's on
the same global batch of 64: each leaf's cosine, the global norm ratio,
and the losses. Prints one JSON line a world and one for the comparison,
each with the cards' name and power limit. Needs as many cards as
max_world.

--gloo: only the step-0 comparison, with max_world gloo ranks sharing
cuda:0 (one card is enough): the batch split's bf16 rounding at 64 /
max_world rows a rank, on the same kernels without NCCL.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

B = 64
CROP = 251  # the circor COLA crop


def ms(fn, iters: int = 5, warm: int = 2) -> float:
    """CUDA-event ms a call of fn after `warm` calls."""
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


def cola_model(dev, seed: int = 0):
    """The full-width operaCT COLA model in train mode, DropPath and dropout off."""
    from ..models.cola import Cola
    from ..models.htsat import HTSATConfig, init_weights

    model = Cola(HTSATConfig(drop_path_rate=0.0), p=0.0)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).train()


def pairs(n_rows: int, seed: int = 1):
    """A COLA batch: two (n_rows, 251, 64) random mel crops."""
    r = np.random.default_rng(seed)
    mel = lambda: (r.standard_normal((n_rows, CROP, 64)) * 10 - 40).astype(np.float32)
    return mel(), mel()


def summed_grads(named, zero=None, grads=None) -> dict:
    """The summed gradients a data-parallel step left, by name, on the host:
    each parameter's .grad (or `grads`, one a parameter), a tensor-parallel
    shard's gathered from the model axis; under ZeRO-3 the shards' gathered."""
    from ..parallel import tensor

    if zero is None:
        out = {}
        for (q, w), g in zip(named, grads if grads is not None else [w.grad for _, w in named]):
            pl = tensor.placement(w)
            out[q] = (pl.gather(g) if pl is not None and pl.kind == "shard" else g).detach().cpu()
        return out
    full, out, o = zero.gather_flat(zero.shard.grad), {}, 0
    for (q, _), n, shape in zip(named, zero.numels, zero.shapes):
        out[q] = full[o:o + n].view(shape).cpu()
        o += n
    return out


def cola_steps(mesh, dev, batches, impl: str = "kernel", zero: bool = False, seed: int = 0,
               before=None, mm_dtype=torch.bfloat16, megatron: bool = False) -> dict:
    """The trainer's COLA step (cola_training.train_step, Adam as the
    trainer builds it; mm_dtype bf16, or float32 with impl "autograd") over
    `batches` (global (x1, x2) pairs; this rank runs its rows), from
    cola_model(seed); zero: ZeRO-3 over the mesh (the trainer's
    shard_params_and_opt); megatron: the model placed on a dp x tp mesh's
    model axis (parallel/tensor.py). before() runs just before the first
    step. -> {"losses", "grads" (step 0's summed, on the host), "model",
    "opt", "zero", "batches" (the rank's rows on dev)}."""
    from ..parallel import tensor
    from ..parallel.mesh import shard_params_and_opt, shard_rows
    from ..pretrain import cola_training as ct
    from ..pretrain import steps

    model = cola_model(dev, seed)
    if megatron and mesh is not None:
        tensor.shard_model(model, mesh)
    named = list(model.named_parameters())
    make_opt = lambda ps: steps.adam_with_epoch_decay(ps, 5)
    zs = None
    if zero and mesh is not None:
        zs, opt = shard_params_and_opt([w for _, w in named], mesh, make_opt)
        zs.release()
    else:
        opt = make_opt([w for _, w in named])
    xs = [tuple(torch.from_numpy(shard_rows(x, mesh)).to(dev) for x in pair) for pair in batches]
    if before is not None:
        before()
    losses, grads = [], None
    for i, (x1, x2) in enumerate(xs):
        loss, _ = ct.train_step(model, opt, x1, x2, None, mm_dtype, impl, 0.0, mesh, zs)
        losses.append(float(loss))
        if i == 0:
            grads = summed_grads(named, zs)
    return {"losses": losses, "grads": grads, "model": model, "opt": opt, "zero": zs,
            "batches": xs}


def _cos(a, b) -> float:
    a, b = a.double().ravel(), b.double().ravel()
    return float(a @ b / (a.norm() * b.norm()))


def grad_report(got: dict, want: dict, bar: float, skip=()) -> dict:
    """Summed gradients against a reference, leaf by leaf: the least cosine
    and its leaf, the count under `bar`, the global norm ratio, bitwise
    equality. Leaves named in `skip` (exact gradient 0: float noise in
    every run) and leaves of norm 0 are left out of the cosines."""
    cos = {q: _cos(got[q], g) for q, g in want.items()
           if not q.endswith(tuple(skip)) and float(g.norm()) > 0}
    lo = min(cos, key=cos.get)
    norm = lambda gs: float(torch.sqrt(sum((g.double() ** 2).sum() for g in gs.values())))
    return {"min_leaf_cosine": cos[lo], "min_leaf": lo, "leaves": len(cos),
            f"leaves_under_{bar}": sum(v < bar for v in cos.values()),
            "norm_ratio": norm(got) / norm(want),
            "bitwise": all(torch.equal(got[q], want[q]) for q in want)}


def step0(mesh):
    """The step-0 loss and summed gradients on the global batch of B."""
    out = cola_steps(mesh, mesh.device, [pairs(B)])
    return out["losses"][0], out["grads"]


def rank(mesh, with_grads: bool):
    """Rank 0's step ms at both batch layouts (and its step-0 result)."""
    from ..pretrain import cola_training as ct

    out = {}
    for layout, rows in (("strong", B // mesh.world), ("weak", B)):
        run = cola_steps(mesh, mesh.device, [])
        x1, x2 = (torch.from_numpy(x).to(mesh.device) for x in pairs(rows))
        out[layout] = ms(lambda: ct.train_step(run["model"], run["opt"], x1, x2, None,
                                               torch.bfloat16, "kernel", 0.0, mesh))
        del run
    if with_grads:
        out["step0"] = step0(mesh)
    return out


def main(argv):
    from ..parallel.launch import launch

    gloo = "--gloo" in argv
    argv = [a for a in argv if a != "--gloo"]
    tag = argv[0] if argv else "dp_scale"
    cards = torch.cuda.device_count()
    top = int(argv[1]) if len(argv) > 1 else cards
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    if gloo:
        loss, grads = launch(step0, top, backend="gloo", device="cuda")
    else:
        worlds = [n for n in (1, 2, 4, 8) if n <= top]
        for n in worlds:
            out = launch(rank, n, n == worlds[-1], backend="nccl", device="cuda")
            print(json.dumps({"tag": tag, "world": n, "cards": smi.splitlines()[:n],
                              "strong_ms": out["strong"], "strong_rows_a_rank": B // n,
                              "weak_ms": out["weak"], "weak_rows_a_rank": B}), flush=True)
        loss, grads = out["step0"]
    one = cola_steps(None, torch.device("cuda"), [pairs(B)])
    rep = grad_report(grads, one["grads"], 0.9999)
    print(json.dumps({"tag": tag, "world": top, "backend": "gloo on cuda:0" if gloo else "nccl",
                      "rows_a_rank": B // top, "vs_one_device": {
                          "loss": loss, "loss_one_device": one["losses"][0], **rep},
                      "cards": smi.splitlines()[0]}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
