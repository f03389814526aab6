"""Data-parallel dry run of both continued-pretraining families — counterpart
of __graft_entry__.py::dryrun_multichip (:46), which covers COLA only.

    python -m heart_murmur_detection_tpu_torch.parallel.dryrun --n=2 --device=cpu

dryrun_multichip(n, device) runs one epoch of CP at tiny shapes on n ranks
(parallel/launch.py, one launch for every case; gloo, which also lets ranks
share one card) and in this process on one device, from the same seeds and
batches, and asserts that the train and valid losses agree:
  1. DP COLA (HTS-AT) on the plain float32 path (rtol 2e-4, the JAX bar);
  2. DP COLA on the kernel route in bf16 (fused_train=True: the train
     kernels on a card, their plain versions on the CPU; rtol 3e-2, the JAX
     package's bf16 DP bar);
  3. ZeRO-3 COLA (param_sharding="fsdp", float32; rtol 2e-4);
  4. DP MAE (the OPERA-GT family's step, float32; rtol 2e-4);
  5. for an even n >= 4, COLA on a dp(n/2) x tp2 mesh with megatron
     placement (a second launch), its losses against the DP COLA run's at
     rtol 2e-4, as __graft_entry__.dryrun_multichip (:150-174) holds them.
Dropout and DropPath are off, since each rank draws its own.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

TINY_HTSAT = dict(spec_size=64, patch_size=4, embed_dim=16, depths=(1, 1, 1, 1),
                  num_heads=(2, 2, 2, 2), window_size=2, mel_bins=16, drop_path_rate=0.0)
TINY_MAE = dict(img_size=(32, 16), patch_size=4, embed_dim=32, depth=1, num_heads=2,
                decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2)


def _corpus(n_train: int, n_val: int, seed: int = 0):
    from ..pretrain.data import Corpus

    r = np.random.default_rng(seed)
    clip = lambda: r.random((40, 16)).astype(np.float32)
    return Corpus("dryrun", [clip() for _ in range(n_train)], [clip() for _ in range(n_val)],
                  max_len=32)


def run_case(mesh, case: str, n: int, root: str, device: str = "cpu"):
    """One case's history (the trainer in this rank, or on `device`)."""
    from ..models.htsat import HTSATConfig
    from ..models.vit_mae import MAEConfig
    from ..pretrain.cola_training import train_multiple_data
    from ..pretrain.mae_training import mae_train_multiple_data

    tag = f"{case}-{'mesh' if mesh is not None else 'single'}"
    common = dict(data_source={"dryrun": 32}, n_epoches=1, batch_size=2 * n, seed=0,
                  ckpt_root=os.path.join(root, tag, "cks"),
                  log_dir=os.path.join(root, tag, "logs"), verbose=False, mesh=mesh,
                  device=device)
    if case == "mae":
        _, hist, _ = mae_train_multiple_data(
            f"dryrun-{case}", corpora=[_corpus(4 * n, 2 * n, 1)],
            config_override=MAEConfig(**TINY_MAE, mask_ratio=0.7), **common)
        return hist
    kw = dict(encoder="htsat", htsat_config=HTSATConfig(**TINY_HTSAT), dropout_p=0.0,
              corpora=[_corpus(4 * n, 2 * n)])
    if case == "tp":
        kw.update(param_sharding="megatron" if mesh is not None else None)
    if case == "kernel":
        kw.update(compute_dtype=torch.bfloat16, fused_train=True)
    if case == "zero3":
        kw.update(param_sharding="fsdp" if mesh is not None else None)
    _, hist, _ = train_multiple_data(f"dryrun-{case}", **kw, **common)
    return hist


CASES = (("dp", 2e-4), ("kernel", 3e-2), ("zero3", 2e-4), ("mae", 2e-4))
TP_RTOL = 2e-4


def run_cases(mesh, cases, n: int, root: str, device: str = "cpu"):
    """run_case of each case in `cases`, in this rank: {case: history}."""
    return {case: run_case(mesh, case, n, root, device) for case in cases}


def _losses(hist):
    return [(h["train_loss"], h["valid_loss"]) for h in hist]


def _check(n, device, case, got, want, rtol, against="one device"):
    if not np.isfinite(got).all():
        raise AssertionError(f"{case}: losses {got}")
    np.testing.assert_allclose(got, want, rtol=rtol, err_msg=case)
    print(f"dryrun_multichip({n}, {device}): {case} ok, train/valid loss "
          f"{got[-1][0]:.6f} / {got[-1][1]:.6f} ({against} {want[-1][0]:.6f} / "
          f"{want[-1][1]:.6f}, rtol {rtol})", flush=True)


def dryrun_multichip(n: int, device: str = "cuda") -> dict:
    """The cases on n gloo ranks against one device (and, for an even n >=
    4, the dp x tp case against the DP one); returns {case: (mesh losses,
    reference losses)} and raises on a mismatch."""
    from .launch import launch

    out = {}
    with tempfile.TemporaryDirectory() as root:
        meshed = launch(run_cases, n, [c for c, _ in CASES], n, root, device, backend="gloo",
                        device=device)
        for case, rtol in CASES:
            got = _losses(meshed[case])
            want = _losses(run_case(None, case, n, root, device))  # in this process
            _check(n, device, case, got, want, rtol)
            out[case] = (got, want)
        if n >= 4 and n % 2 == 0:
            tp = _losses(launch(run_case, n, "tp", n, root, device, backend="gloo",
                                device=device, tp=2))
            _check(n, device, f"dp{n // 2}xtp2", tp, out["dp"][0], TP_RTOL, f"dp{n}")
            out["tp"] = (tp, out["dp"][0])
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    dryrun_multichip(a.n, a.device)
