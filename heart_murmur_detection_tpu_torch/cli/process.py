"""Dataset processing and embedding extraction CLI — counterpart of
heart_murmur_detection_tpu/cli/process.py (`main` :19) on the port's
processors and FeatureExtractor.

Usage:
  python -m heart_murmur_detection_tpu_torch.cli.process dataset=circor pretrain=operaCT dim=768 source_sr=4000
  python -m heart_murmur_detection_tpu_torch.cli.process dataset=pascal data=A pretrain=operaGT dim=384
  python -m heart_murmur_detection_tpu_torch.cli.process dataset=circor   # the config: operaCE, dim 1280
  python -m heart_murmur_detection_tpu_torch.cli.process dataset=circor pretrain=vggish random_init=True
  python -m heart_murmur_detection_tpu_torch.cli.process dataset=circor pretrain=opensmile

The config's default pretrain, operaCE, loads cks/model/encoder-operaCE.ckpt
(random_init=True or pretrain=null for random weights) and saves
operaCE1280_feature.npy; vggish (random weights with random_init: the
repository has no VGGish checkpoint) and opensmile (host numpy emobase,
with a provenance sidecar) save vggish_feature.npy / opensmile_feature.npy.

Runs from the directory that holds datasets/ and writes feature/<task>_eval/.
The extraction runs on the card; `device=cpu` runs it on the CPU.
"""

from __future__ import annotations

import os
import sys

from ..data.processors import circor, pascal, physionet16, zchsound
from ..data.processors.common import extract_and_save
from ..extract.registry import default_input_sec
from .config import resolve


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    outs = []
    for cfg in resolve("process_config", argv):
        dataset = cfg["dataset"]
        if dataset == "circor":
            fdir = (
                "feature/circor_eval_train_only/"
                if cfg.get("train_only")
                else "feature/circor_eval/"
            )
            if not os.path.exists(os.path.join(fdir, "train_test_split.npy")):
                os.makedirs(fdir, exist_ok=True)
                if cfg.get("train_only"):
                    circor.preprocess_split(feature_dir=fdir)
                else:
                    circor.read_data(feature_dir=fdir)
        elif dataset == "pascal":
            sub = cfg.get("data", "A")
            fdir = pascal.feature_dir_for(sub)
            if not os.path.exists(os.path.join(fdir, "train_test_split.npy")):
                os.makedirs(fdir, exist_ok=True)
                pascal.preprocess_split(sub, feature_dir=fdir)
        elif dataset == "zchsound":
            sub = cfg.get("data", "clean")
            fdir = f"feature/zchsound_{sub}_eval/"
            if not os.path.exists(os.path.join(fdir, "train_test_split.npy")):
                os.makedirs(fdir, exist_ok=True)
                zchsound.preprocess_split(sub, feature_dir=fdir)
        elif dataset == "physionet16":
            fdir = "feature/physionet16_eval/"
            if not os.path.exists(os.path.join(fdir, "train_test_split.npy")):
                os.makedirs(fdir, exist_ok=True)
                physionet16.preprocess_split_independent(feature_dir=fdir)
        else:
            raise SystemExit(f"unknown dataset: {dataset}")

        pretrain = cfg.get("pretrain")
        if pretrain and pretrain != "None":
            input_sec = default_input_sec(
                pretrain, cfg.get("min_len_htsat", 8), cfg.get("min_len_cnn", 8)
            )
            out = extract_and_save(
                fdir,
                pretrain,
                input_sec=input_sec,
                dim=cfg.get("dim", 1280),
                ckpt_path=cfg.get("ckpt_path"),
                pad0=(dataset == "circor"),
                fine_tuned=cfg.get("fine_tuned"),
                seed=cfg.get("seed"),
                random_init=bool(cfg.get("random_init", False)),
                wire_format=cfg.get("wire_format", "int16"),
                source_sr=(
                    int(cfg["source_sr"])
                    if cfg.get("source_sr") not in (None, "None")
                    else None
                ),
                device=cfg.get("device", "cuda"),
            )
            print("saved features:", out)
            outs.append(out)
    return outs


if __name__ == "__main__":
    main()
