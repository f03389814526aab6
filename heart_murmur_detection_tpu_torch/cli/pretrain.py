"""Continued-pretraining CLI (COLA) — counterpart of
heart_murmur_detection_tpu/cli/pretrain.py, reading the same
configs/pretrain_config.yaml.

Usage:
  python -m heart_murmur_detection_tpu_torch.cli.pretrain encoder=htsat method=cola \\
      compute_dtype=bfloat16 circor=True physionet16=True title=operaCT-heart-all epoches=250
  ... device=cpu              # on the CPU (plain versions of the kernels)
  ... pretrain=operaCT ckpt_path=cks/model/encoder-operaCT.ckpt   # warm start

Runs on one device (device=cuda by default). method=mae|audiomae (MAE
pretraining) and the multi-device keys dp / tp / param_sharding are not
ported and raise NotImplementedError.
"""

from __future__ import annotations

import sys

from ..pretrain.cola_training import train_multiple_data
from ..pretrain.data import OPTIMAL_MAX_LEN_COLA
from .config import parse_compute_dtype, resolve


def main(argv=None):
    """Run every configuration of the (multirun-aware) overrides; returns
    their (state_dict, history, best checkpoint path) results."""
    argv = sys.argv[1:] if argv is None else argv
    results = []
    for cfg in resolve("pretrain_config", argv):
        method = cfg.get("method", "cola")
        if method != "cola":
            raise NotImplementedError(f"method={method}: MAE pretraining is not ported")
        if int(cfg.get("dp", 1)) > 1 or int(cfg.get("tp", 1)) > 1 or cfg.get("param_sharding"):
            raise NotImplementedError("multi-device CP (dp, tp, param_sharding) is not ported")
        data_source = {dt: ml for dt, ml in OPTIMAL_MAX_LEN_COLA.items() if cfg.get(dt) is True}
        if not data_source:
            raise SystemExit("no corpora enabled (set e.g. circor=True)")
        results.append(train_multiple_data(
            cfg["title"],
            data_source=data_source,
            dim_hidden=cfg.get("dim_hidden", 1280),
            dim_out=cfg.get("dim_out", 512),
            encoder=cfg.get("encoder", "efficientnet"),
            n_epoches=cfg.get("epoches", 512),
            pretrain=cfg.get("pretrain"),
            freeze_encoder=cfg.get("freeze_encoder", "none"),
            batch_size=int(cfg.get("batch_size", 64)),
            lr=float(cfg.get("lr", 1e-4)),
            seed=cfg.get("seed", 42),
            compute_dtype=parse_compute_dtype(cfg),
            resume=bool(cfg.get("resume", False)),
            fused_train=cfg.get("fused_train"),
            device=cfg.get("device", "cuda"),
            ckpt_path=cfg.get("ckpt_path"),
        ))
    return results


if __name__ == "__main__":
    main()
