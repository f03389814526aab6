"""PhysioNet/CinC 2016 processor (physionet16_processing.py): a numpy copy
of heart_murmur_detection_tpu/data/processors/physionet16.py that writes the
same files (sklearn's splits come from ..splits).

Labels normal=0/abnormal=1 from the last line of each .hea file (:61-67); SQI
quality annotations from REFERENCE_withSQI.csv (:42-57). Two split modes:
- source-independent (:121-204): training-a/e 80/20 (seed 1337), b/c
  train-only, d/f test-only; combined train/val 80/20 (seed 42); in-domain
  pretrain 50/50 (seed 42)
- stratified 64/16/20 variant (:207-257, seed 1337 then pretrain seed 42)
"""

from __future__ import annotations

import csv
import glob
import os

import numpy as np

from ..splits import train_test_split
from .common import save_json

DATA_DIR = "datasets/physionet.org/files/challenge-2016/1.0.0/"
FEATURE_DIR = "feature/physionet16_eval/"
TRAINING_DIRS = ["training-a", "training-b", "training-c", "training-d", "training-e", "training-f"]
LABEL_TO_INT = {"normal": 0, "abnormal": 1}


def read_data(data_dir: str = DATA_DIR, feature_dir: str = FEATURE_DIR):
    save_json(feature_dir, "label_to_int.json", LABEL_TO_INT)
    save_json(feature_dir, "int_to_label.json", {v: k for k, v in LABEL_TO_INT.items()})

    sound_files, labels, annotations = [], [], []
    for d in TRAINING_DIRS:
        audio_dir = os.path.join(data_dir, d)
        ann_file = os.path.join(data_dir, "annotations/updated", d, "REFERENCE_withSQI.csv")
        quality = {}
        if os.path.exists(ann_file):
            with open(ann_file) as f:
                for row in csv.reader(f):
                    if len(row) >= 3:
                        quality[row[0].strip()] = row[2].strip()
        for file in sorted(glob.glob(os.path.join(audio_dir, "*.wav"))):
            hea = file.replace(".wav", ".hea")
            with open(hea) as f:
                lines = f.readlines()
            label = lines[-1].strip().lstrip("#").strip().lower()
            labels.append(LABEL_TO_INT[label])
            base = os.path.basename(file).split(".")[0]
            annotations.append(quality.get(base, 0))
            sound_files.append(file)
    return np.array(sound_files), np.array(labels, np.int32), np.array(annotations)


def preprocess_split_independent(data_dir: str = DATA_DIR, feature_dir: str = FEATURE_DIR):
    sound_files, labels, annotations = read_data(data_dir, feature_dir)
    np.save(os.path.join(feature_dir, "sound_dir_loc.npy"), sound_files)

    groups = {"a": ([], []), "e": ([], []), "train_only": ([], []), "test_only": ([], [])}
    for f, y in zip(sound_files, labels):
        if "training-a" in f:
            g = "a"
        elif "training-e" in f:
            g = "e"
        elif "training-b" in f or "training-c" in f:
            g = "train_only"
        else:
            g = "test_only"
        groups[g][0].append(f)
        groups[g][1].append(y)

    a_tv, a_te, a_tvl, _ = train_test_split(
        *groups["a"], test_size=0.2, random_state=1337, stratify=groups["a"][1]
    )
    e_tv, e_te, e_tvl, _ = train_test_split(
        *groups["e"], test_size=0.2, random_state=1337, stratify=groups["e"][1]
    )
    tv_files = list(a_tv) + list(e_tv) + groups["train_only"][0]
    tv_labels = list(a_tvl) + list(e_tvl) + groups["train_only"][1]
    x_train, x_val, _, _ = train_test_split(
        tv_files, tv_labels, test_size=0.2, random_state=42, stratify=tv_labels
    )
    x_tp, _ = train_test_split(x_train, test_size=0.5, random_state=42)

    tr, va, tp = set(x_train), set(x_val), set(x_tp)
    audio_splits, pretrain_splits = [], []
    for f in sound_files:
        if f in tr:
            audio_splits.append("train")
            pretrain_splits.append("train_pretrain" if f in tp else "train")
        elif f in va:
            audio_splits.append("val")
            pretrain_splits.append("val")
        else:
            audio_splits.append("test")
            pretrain_splits.append("test")

    np.save(os.path.join(feature_dir, "train_test_split.npy"), audio_splits)
    np.save(os.path.join(feature_dir, "labels.npy"), labels)
    np.save(os.path.join(feature_dir, "train_test_pretrain_split.npy"), pretrain_splits)
    np.save(os.path.join(feature_dir, "annotations.npy"), annotations)


def preprocess_split(data_dir: str = DATA_DIR, feature_dir: str = FEATURE_DIR):
    sound_files, labels, annotations = read_data(data_dir, feature_dir)
    _xt, x_test, _yt, _ = train_test_split(
        sound_files, labels, test_size=0.2, random_state=1337, stratify=labels
    )
    x_train, x_val, _, _ = train_test_split(
        _xt, _yt, test_size=0.2, random_state=1337, stratify=_yt
    )
    x_tp, _ = train_test_split(x_train, test_size=0.5, random_state=42)
    tr, va, tp = set(x_train), set(x_val), set(x_tp)

    np.save(os.path.join(feature_dir, "sound_dir_loc.npy"), sound_files)
    audio_splits, pretrain_splits = [], []
    for f in sound_files:
        if f in tr:
            audio_splits.append("train")
            pretrain_splits.append("train_pretrain" if f in tp else "train")
        elif f in va:
            audio_splits.append("val")
            pretrain_splits.append("val")
        else:
            audio_splits.append("test")
            pretrain_splits.append("test")
    np.save(os.path.join(feature_dir, "train_test_split.npy"), audio_splits)
    np.save(os.path.join(feature_dir, "labels.npy"), labels)
    np.save(os.path.join(feature_dir, "train_test_pretrain_split.npy"), pretrain_splits)
    np.save(os.path.join(feature_dir, "annotations.npy"), annotations)
