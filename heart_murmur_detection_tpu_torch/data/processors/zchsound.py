"""ZCHSound processor (zchsound_processing.py), a copy of
heart_murmur_detection_tpu/data/processors/zchsound.py that writes the same
files: outcomes {ASD=0, NORMAL=1, PDA=2, PFO=3, VSD=4}, binary murmurs
(NORMAL=0 else 1) from ;-delimited CSV; stratified 64/16/20 by patient,
seed 42."""

from __future__ import annotations

import csv
import glob
import os

import numpy as np

from .common import save_json, stratified_64_16_20

DATA_DIR = "datasets/ZCHSound/"
INT_TO_MURMURS = {"0": "Absent", "1": "Present"}
INT_TO_OUTCOMES = {"0": "ASD", "1": "NORMAL", "2": "PDA", "3": "PFO", "4": "VSD"}
MURMURS_TO_INT = {"NORMAL": 0, "ASD": 1, "PDA": 1, "PFO": 1, "VSD": 1}
OUTCOMES_TO_INT = {"ASD": 0, "NORMAL": 1, "PDA": 2, "PFO": 3, "VSD": 4}

VARIANTS = {
    "clean": (
        "clean Heartsound Data",
        "feature/zchsound_clean_eval/",
        "Clean Heartsound Data Details.csv",
    ),
    "noisy": (
        "Noise Heartsound Data Details",
        "feature/zchsound_noisy_eval/",
        "Noise Heartsound Data Details.csv",
    ),
}


def get_labels_from_csv(path: str, feature_dir: str):
    label_dict = {}
    with open(path) as f:
        reader = csv.reader(f, delimiter=";")
        next(reader)
        for row in reader:
            label_dict[row[0]] = row[3]
    save_json(feature_dir, "int_to_outcomes.json", INT_TO_OUTCOMES)
    save_json(feature_dir, "int_to_murmurs.json", INT_TO_MURMURS)
    return label_dict


def preprocess_split(data: str = "clean", data_dir: str = DATA_DIR, feature_dir=None):
    audio_sub, default_fd, csv_name = VARIANTS[data]
    feature_dir = feature_dir or default_fd
    audio_dir = os.path.join(data_dir, audio_sub)
    label_dict = get_labels_from_csv(os.path.join(data_dir, csv_name), feature_dir)

    patient_ids = list(label_dict.keys())
    outcomes = [OUTCOMES_TO_INT[label_dict[u]] for u in patient_ids]
    splits_by_pid = dict(
        zip(patient_ids, stratified_64_16_20(patient_ids, outcomes, seed=42))
    )

    sound_files = np.array(sorted(glob.glob(os.path.join(audio_dir, "*.wav"))))
    np.save(os.path.join(feature_dir, "sound_dir_loc.npy"), sound_files)
    audio_splits, outcome_labels, murmur_labels = [], [], []
    for f in sound_files:
        fid = os.path.basename(f)
        audio_splits.append(splits_by_pid.get(fid, "test"))
        outcome_labels.append(OUTCOMES_TO_INT[label_dict[fid]])
        murmur_labels.append(MURMURS_TO_INT[label_dict[fid]])
    np.save(os.path.join(feature_dir, "train_test_split.npy"), audio_splits)
    np.save(os.path.join(feature_dir, "outcomes.npy"), np.array(outcome_labels, np.int32))
    np.save(os.path.join(feature_dir, "murmurs.npy"), np.array(murmur_labels, np.int32))
