"""Continued-pretraining CLI (COLA, MAE, Audio-MAE) — counterpart of
heart_murmur_detection_tpu/cli/pretrain.py, reading the same
configs/pretrain_config.yaml.

Usage:
  python -m heart_murmur_detection_tpu_torch.cli.pretrain encoder=htsat method=cola \\
      compute_dtype=bfloat16 circor=True physionet16=True title=operaCT-heart-all epoches=250
  python -m heart_murmur_detection_tpu_torch.cli.pretrain encoder=efficientnet method=cola \\
      compute_dtype=bfloat16 circor=True title=operaCE-heart-circor
  python -m heart_murmur_detection_tpu_torch.cli.pretrain method=audiomae \\
      compute_dtype=bfloat16 circor=True pascal_A=True title=audiomae-heart-all
  python -m heart_murmur_detection_tpu_torch.cli.pretrain method=mae \\
      compute_dtype=bfloat16 covidbreath=True covidcough=True title=gt-resp
  ... device=cpu              # on the CPU (plain versions of the kernels)
  ... pretrain=operaCT ckpt_path=cks/model/encoder-operaCT.ckpt   # warm start
  ... pretrain=audiomae ckpt_path=src/benchmark/baseline/audioMAE/pretrained.pth

The config's default encoder is the EfficientNet (OPERA-CE). Runs on one
device (device=cuda by default). The corpora and their max_len
follow the method: the COLA table, the MAE table (respiratory corpora), or
1024 frames for every heart corpus with audiomae. The multi-device keys
dp / tp / param_sharding are not ported and raise NotImplementedError.
"""

from __future__ import annotations

import sys

from ..pretrain.cola_training import train_multiple_data
from ..pretrain.data import OPTIMAL_MAX_LEN_COLA, OPTIMAL_MAX_LEN_MAE
from ..pretrain.mae_training import mae_train_multiple_data
from .config import parse_compute_dtype, resolve

HEART_CORPORA = ("circor", "pascal_A", "pascal_B", "physionet16", "zchsound_clean",
                 "zchsound_noisy")


def main(argv=None):
    """Run every configuration of the (multirun-aware) overrides; returns
    their (state_dict, history, best checkpoint path) results."""
    argv = sys.argv[1:] if argv is None else argv
    results = []
    for cfg in resolve("pretrain_config", argv):
        method = cfg.get("method", "cola")
        if int(cfg.get("dp", 1)) > 1 or int(cfg.get("tp", 1)) > 1 or cfg.get("param_sharding"):
            raise NotImplementedError("multi-device CP (dp, tp, param_sharding) is not ported")
        if method == "cola":
            max_lens = OPTIMAL_MAX_LEN_COLA
        elif method == "mae":
            max_lens = OPTIMAL_MAX_LEN_MAE
        else:  # audiomae
            max_lens = {k: 1024 for k in HEART_CORPORA}
        data_source = {dt: ml for dt, ml in max_lens.items() if cfg.get(dt) is True}
        if not data_source:
            raise SystemExit("no corpora enabled (set e.g. circor=True)")
        common = dict(
            n_epoches=cfg.get("epoches", 512),
            pretrain=cfg.get("pretrain"),
            batch_size=int(cfg.get("batch_size", 64)),
            lr=float(cfg.get("lr", 1e-4)),
            seed=cfg.get("seed", 42),
            compute_dtype=parse_compute_dtype(cfg),
            resume=bool(cfg.get("resume", False)),
            fused_train=cfg.get("fused_train"),
            device=cfg.get("device", "cuda"),
            ckpt_path=cfg.get("ckpt_path"),
        )
        if method != "cola":
            results.append(mae_train_multiple_data(
                cfg["title"], data_source=data_source, training_method=method, **common))
            continue
        results.append(train_multiple_data(
            cfg["title"],
            data_source=data_source,
            dim_hidden=cfg.get("dim_hidden", 1280),
            dim_out=cfg.get("dim_out", 512),
            encoder=cfg.get("encoder", "efficientnet"),
            freeze_encoder=cfg.get("freeze_encoder", "none"),
            **common,
        ))
    return results


if __name__ == "__main__":
    main()
