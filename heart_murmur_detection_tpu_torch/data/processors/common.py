"""Shared helpers for the dataset processors — counterpart of
heart_murmur_detection_tpu/data/processors/common.py. Every processor writes
the feature/<task>_eval/ contract of the reference: sound_dir_loc.npy,
train_test_split.npy, <labels>.npy, int_to_*.json, and extract_and_save
adds <model><dim>_feature.npy under the JAX package's name, so either
package's probe reads either package's features.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from ..splits import train_test_split


def save_json(feature_dir: str, name: str, mapping: Dict) -> None:
    os.makedirs(feature_dir, exist_ok=True)
    with open(os.path.join(feature_dir, name), "w") as f:
        json.dump(mapping, f)


def stratified_64_16_20(files, labels, seed: int):
    """64/16/20 split: 20% test then 20% of remainder as val (both stratified)."""
    _x_train, x_test, _y_train, _ = train_test_split(
        files, labels, test_size=0.2, random_state=seed, stratify=labels
    )
    x_train, x_val, _, _ = train_test_split(
        _x_train, _y_train, test_size=0.2, random_state=seed, stratify=_y_train
    )
    tr, va = set(x_train), set(x_val)
    return ["train" if f in tr else "val" if f in va else "test" for f in files]


def extract_and_save(
    feature_dir: str,
    pretrain: str,
    input_sec: float = 8,
    dim: int = 1280,
    ckpt_path: Optional[str] = None,
    pad0: bool = False,
    fine_tuned: Optional[str] = None,
    seed=None,
    random_init: bool = False,
    batch_size: int = 16,
    wire_format: str = "int16",
    source_sr: Optional[int] = None,
    device="cuda",
) -> str:
    """Batched extraction of a processed feature dir on the port's
    FeatureExtractor; saves and returns <pretrain><dim>_feature.npy
    (processing scripts' extract_and_save_embeddings). source_sr ships the
    clips at that rate and upsamples on the device (CirCor: 4000). The
    baseline encoders route to their module extractors and save
    <name>_feature.npy, as the JAX package's dispatch does
    (circor_processing.py:241-258), whatever input_sec says: hear runs
    models/hear.py::extract_hear_feature (2-s clips at 16 kHz), clap and
    clap2023 models/clap.py::extract_clap_feature (5-s / 7-s clips at
    44.1 kHz, the 2023 tower on the swin kernels on a card); their weights
    are random with random_init, else loaded from ckpt_path. vggish runs
    models/vggish.py::extract_vgg_feature (0.96-s examples at 16 kHz, the
    network in float32 on the device; random weights with random_init, as
    the JAX package has no VGGish checkpoint path), opensmile the emobase
    functionals of each file on the host (models/vggish.py::
    extract_opensmile_features) and writes
    opensmile_feature.provenance.json naming the implementation.
    operaCE (and null / null-efficientnet) runs FeatureExtractor's
    EfficientNet graph and saves operaCE1280_feature.npy or
    operaCE512_feature.npy."""
    from ...extract.extract import FeatureExtractor

    sound_dir_loc = np.load(os.path.join(feature_dir, "sound_dir_loc.npy"))
    if pretrain in ("vggish", "hear", "clap", "clap2023", "opensmile"):
        paths = [str(f) for f in sound_dir_loc]
        kw = dict(ckpt_path=ckpt_path, random_init=random_init, batch_size=batch_size,
                  device=device)
        if pretrain == "vggish":
            from ...models.vggish import extract_vgg_feature

            feats = extract_vgg_feature(paths, random_init=random_init, device=device)
        elif pretrain == "hear":
            from ...models.hear import extract_hear_feature

            feats = extract_hear_feature(paths, **kw)
        elif pretrain in ("clap", "clap2023"):
            from ...models.clap import extract_clap_feature

            feats = extract_clap_feature(
                paths, version="2023" if pretrain == "clap2023" else "2022", **kw)
        else:
            from ...models.vggish import extract_opensmile_features, opensmile_impl

            feats = np.stack([np.asarray(extract_opensmile_features(p)).reshape(-1)
                              for p in paths])
            # pip-opensmile and the native-emobase fallback are correlated but
            # not bit-identical: record which one built this cache
            with open(os.path.join(feature_dir, pretrain + "_feature.provenance.json"), "w") as f:
                json.dump({"impl": opensmile_impl()}, f)
        out = os.path.join(feature_dir, pretrain + "_feature.npy")
        np.save(out, np.asarray(feats))
        return out
    ex = FeatureExtractor(
        pretrain,
        dim=dim,
        input_sec=input_sec,
        ckpt_path=ckpt_path,
        pad0=pad0,
        random_init=random_init,
        batch_size=batch_size,
        wire_format=wire_format,
        source_sr=source_sr,
        device=device,
    )
    feats = ex.extract_files([str(f) for f in sound_dir_loc])
    name = pretrain + ("" if "audiomae" in pretrain else str(dim))
    suffix = "" if not fine_tuned else f"_finetuned_{fine_tuned}_{seed}"
    out = os.path.join(feature_dir, name + suffix + "_feature.npy")
    np.save(out, feats)
    return out
