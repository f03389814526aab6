"""PASCAL heart-sound challenge processor (pascal_processing.py): a copy of
heart_murmur_detection_tpu/data/processors/pascal.py that writes the same
files.

A: {normal=0, murmur=1, extrahls=2, artifact=3}; B: {normal=0, murmur=1,
extrastole=2} from directory names (:34-49); stratified 64/16/20 seed 1337."""

from __future__ import annotations

import glob
import os

import numpy as np

from .common import save_json, stratified_64_16_20

DATA_DIR = "datasets/PASCAL/"

DIRS = {
    "A": [
        "Atraining_artifact",
        "Atraining_extrahls",
        "Atraining_murmur",
        "Atraining_normal",
    ],
    "B": ["Btraining_extrastole", "Btraining_murmur", "BTraining_normal"],
}
LABELS = {
    "A": {"normal": 0, "murmur": 1, "extrahls": 2, "artifact": 3},
    "B": {"normal": 0, "murmur": 1, "extrastole": 2},
}


def feature_dir_for(dataset: str) -> str:
    return f"feature/pascal_{dataset}_eval/"


def preprocess_split(dataset: str = "A", data_dir: str = DATA_DIR, feature_dir=None):
    feature_dir = feature_dir or feature_dir_for(dataset)
    label_to_int = LABELS[dataset]
    save_json(feature_dir, "label_to_int.json", label_to_int)
    save_json(feature_dir, "int_to_label.json", {v: k for k, v in label_to_int.items()})

    sound_files, labels = [], []
    for d in DIRS[dataset]:
        files = sorted(glob.glob(os.path.join(data_dir, d, "*.wav")))
        label = label_to_int[d.split("_")[1]]
        sound_files.extend(files)
        labels.extend([label] * len(files))
    sound_files = np.array(sound_files)
    labels = np.array(labels, np.int32)

    np.save(os.path.join(feature_dir, "sound_dir_loc.npy"), sound_files)
    splits = stratified_64_16_20(list(sound_files), labels, seed=1337)
    np.save(os.path.join(feature_dir, "train_test_split.npy"), splits)
    np.save(os.path.join(feature_dir, "labels.npy"), labels)
