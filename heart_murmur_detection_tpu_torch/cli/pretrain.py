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

  ... dp=2 dist_backend=gloo device=cpu     # data parallel: 2 ranks on the CPU
  ... dp=2 param_sharding=fsdp                # ZeRO-3 over 2 cards (NCCL)

The config's default encoder is the EfficientNet (OPERA-CE). Runs on one
device (device=cuda by default). The corpora and their max_len
follow the method: the COLA table, the MAE table (respiratory corpora), or
1024 frames for every heart corpus with audiomae. dp=N runs N ranks
(parallel/launch.py; dist_backend nccl, the default on a card, takes one
card a rank; gloo, the CPU's default, lets ranks share a card) and returns
rank 0's result; param_sharding=fsdp is ZeRO-3 over them (parallel/
mesh.py::mesh_from_cli: param_sharding without dp > 1 is an error). dp=N
tp=M runs N x M ranks on a dp x tp mesh: megatron tensor parallelism over
the M model ranks (the HTS-AT's, the MAE ViT's and the SwinV2-CR decoder's
blocks) unless param_sharding=fsdp (ZeRO-3 over the model axis), e.g.

  python -m heart_murmur_detection_tpu_torch.cli.pretrain encoder=htsat method=cola circor=True dp=2 tp=2 dist_backend=gloo batch_size=4 epoches=1 title=t
"""

from __future__ import annotations

import sys

from ..parallel.launch import launch
from ..parallel.mesh import mesh_from_cli
from ..pretrain.cola_training import train_multiple_data
from ..pretrain.data import OPTIMAL_MAX_LEN_COLA, OPTIMAL_MAX_LEN_MAE
from ..pretrain.mae_training import mae_train_multiple_data
from .config import parse_compute_dtype, resolve

HEART_CORPORA = ("circor", "pascal_A", "pascal_B", "physionet16", "zchsound_clean",
                 "zchsound_noisy")


def train(mesh, method: str, kw: dict):
    """One configuration's trainer (in every rank of a data-parallel run)."""
    if method != "cola":
        return mae_train_multiple_data(mesh=mesh, **kw)
    return train_multiple_data(mesh=mesh, **kw)


def main(argv=None):
    """Run every configuration of the (multirun-aware) overrides; returns
    their (state_dict, history, best checkpoint path) results (rank 0's
    with dp > 1)."""
    argv = sys.argv[1:] if argv is None else argv
    results = []
    for cfg in resolve("pretrain_config", argv):
        method = cfg.get("method", "cola")
        plan, param_sharding = mesh_from_cli(cfg)
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
            param_sharding=param_sharding,
            title=cfg["title"],
            data_source=data_source,
        )
        if method != "cola":
            kw = dict(training_method=method, **common)
        else:
            kw = dict(dim_hidden=cfg.get("dim_hidden", 1280), dim_out=cfg.get("dim_out", 512),
                      encoder=cfg.get("encoder", "efficientnet"),
                      freeze_encoder=cfg.get("freeze_encoder", "none"), **common)
        if plan is None:
            results.append(train(None, method, kw))
        else:
            results.append(launch(train, plan.world, method, kw, backend=plan.backend,
                                  device=common["device"], tp=plan.tp))
    return results


if __name__ == "__main__":
    main()
