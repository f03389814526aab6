"""CirCor DigiScope processor (src/benchmark/processing/circor_processing.py):
a numpy copy of heart_murmur_detection_tpu/data/processors/circor.py that
writes the same files (sklearn's splits come from ..splits).

Labels parsed from per-patient <pat_id>.txt headers: murmurs {Absent=0,
Present=1, Unknown=2}, outcomes {Abnormal=0, Normal=1}, six systolic-murmur
characteristics with NaN for absent (:24-58, :114-135). Uses the dataset's own
test/training/validation directories (:94-142) plus a 50/50 train_pretrain
split of train (seed 42, :158-171). Alternative CSV-driven 64/16/20 split with
seed 42 (preprocess_split :197-235).
"""

from __future__ import annotations

import glob
import os
from typing import Dict

import numpy as np

from ..splits import train_test_split
from .common import save_json, stratified_64_16_20

DATA_DIR = "datasets/circor/"
FEATURE_DIR = "feature/circor_eval/"

INT_TO_MURMURS = {"0": "Absent", "1": "Present", "2": "Unknown"}
INT_TO_OUTCOMES = {"0": "Abnormal", "1": "Normal"}
MURMURS_TO_INT = {"Absent": "0", "Present": "1", "Unknown": "2"}
OUTCOME_TO_INT = {"Abnormal": "0", "Normal": "1"}

CHARS_TO_INT: Dict[str, Dict[str, object]] = {
    "Systolic murmur timing": {
        "nan": np.nan, "Early-systolic": "0", "Holosystolic": "1",
        "Mid-systolic": "2", "Late-systolic": "3",
    },
    "Systolic murmur shape": {
        "nan": np.nan, "Decrescendo": "0", "Plateau": "1", "Diamond": "2",
        "Crescendo": "3",
    },
    "Systolic murmur grading": {"nan": np.nan, "II/VI": "0", "I/VI": "1", "III/VI": "2"},
    "Systolic murmur pitch": {"nan": np.nan, "Medium": "0", "Low": "1", "High": "2"},
    "Systolic murmur quality": {
        "nan": np.nan, "Harsh": "0", "Blowing": "1", "Musical": "2",
    },
    "Systolic murmur grading w absent": {
        "nan": "0", "II/VI": "1", "I/VI": "1", "III/VI": "2"
    },
}


def _char_filename(c: str) -> str:
    return "-".join(c.lower().split(" "))


def save_mappings_json(feature_dir: str = FEATURE_DIR) -> None:
    save_json(feature_dir, "int_to_murmurs.json", INT_TO_MURMURS)
    save_json(feature_dir, "int_to_outcomes.json", INT_TO_OUTCOMES)
    for c, to_int in CHARS_TO_INT.items():
        int_to = {str(v): k for k, v in to_int.items()}
        save_json(feature_dir, f"int_to_{_char_filename(c)}.json", int_to)


def read_data(data_dir: str = DATA_DIR, feature_dir: str = FEATURE_DIR) -> None:
    """Directory-provided splits + header-parsed labels (:92-171)."""
    save_mappings_json(feature_dir)
    dirs = ["test_data", "training_data", "validation_data"]

    sound_files, murmurs, outcomes, audio_splits = [], [], [], []
    murmur_chars = {c: [] for c in CHARS_TO_INT}
    for d in dirs:
        audio_dir = os.path.join(data_dir, d)
        files = sorted(glob.glob(os.path.join(audio_dir, "*.wav")))
        for file in files:
            pat_id = os.path.basename(file).split("_")[0]
            murmur = None
            with open(os.path.join(audio_dir, f"{pat_id}.txt")) as f:
                for line in f:
                    if line.startswith("#Murmur:"):
                        murmur = MURMURS_TO_INT[line.split(":")[1].strip()]
                        murmurs.append(murmur)
                    elif line.startswith("#Outcome:"):
                        outcomes.append(OUTCOME_TO_INT[line.split(":")[1].strip()])
                    else:
                        for c in murmur_chars:
                            if line.startswith(f"#{c}"):
                                murmur_chars[c].append(
                                    CHARS_TO_INT[c][line.split(":")[1].strip()]
                                )
                            elif line.startswith(f"#{c.removesuffix(' w absent')}"):
                                if INT_TO_MURMURS[murmur] == "Unknown":
                                    murmur_chars[c].append(np.nan)
                                else:
                                    murmur_chars[c].append(
                                        CHARS_TO_INT[c][line.split(":")[1].strip()]
                                    )
        sound_files.extend(files)
        split = d.split("_")[0]
        split = {"validation": "val", "training": "train"}.get(split, split)
        audio_splits.extend([split] * len(files))

    for c, val in murmur_chars.items():
        np.save(
            os.path.join(feature_dir, f"{_char_filename(c)}.npy"),
            np.array(val, dtype=np.float32),
        )
    np.save(os.path.join(feature_dir, "sound_dir_loc.npy"), np.array(sound_files))
    np.save(os.path.join(feature_dir, "train_test_split.npy"), audio_splits)
    np.save(os.path.join(feature_dir, "murmurs.npy"), np.array(murmurs, np.int32))
    np.save(os.path.join(feature_dir, "outcomes.npy"), np.array(outcomes, np.int32))

    # 50/50 in-domain pretrain split of train (seed 42)
    train_files = [f for f, s in zip(sound_files, audio_splits) if s == "train"]
    train_pretrain, _ = train_test_split(train_files, test_size=0.5, random_state=42)
    tp = set(train_pretrain)
    pretrain_splits = [
        "train_pretrain" if (s == "train" and f in tp) else s
        for f, s in zip(sound_files, audio_splits)
    ]
    np.save(
        os.path.join(feature_dir, "train_test_pretrain_split.npy"), pretrain_splits
    )


def preprocess_split(
    data_dir: str = DATA_DIR, feature_dir: str = FEATURE_DIR
) -> None:
    """CSV-driven stratified 64/16/20 split, seed 42 (:197-235)."""
    import csv

    save_mappings_json(feature_dir)
    file_ids, murmurs = [], []
    label_by_id, outcome_by_id = {}, {}
    with open(os.path.join(data_dir, "training_data.csv")) as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            pat_id, locs, murmur, outcome = row[0], row[1], row[7], row[20]
            for loc in locs.split("+"):
                fid = f"{pat_id}_{loc}"
                file_ids.append(fid)
                murmurs.append(MURMURS_TO_INT[murmur])
                label_by_id[fid] = MURMURS_TO_INT[murmur]
                outcome_by_id[fid] = OUTCOME_TO_INT[outcome]

    sound_files = np.array(
        sorted(glob.glob(os.path.join(data_dir, "training_data", "*.wav")))
    )
    np.save(os.path.join(feature_dir, "sound_dir_loc.npy"), sound_files)
    ids = [os.path.basename(f).split(".")[0] for f in sound_files]
    splits = stratified_64_16_20(file_ids, murmurs, seed=42)
    split_by_id = dict(zip(file_ids, splits))
    audio_splits = [split_by_id.get(i, "test") for i in ids]
    np.save(os.path.join(feature_dir, "train_test_split.npy"), audio_splits)
    np.save(
        os.path.join(feature_dir, "murmurs.npy"),
        np.array([label_by_id.get(i, "0") for i in ids], np.int32),
    )
    np.save(
        os.path.join(feature_dir, "outcomes.npy"),
        np.array([outcome_by_id.get(i, "0") for i in ids], np.int32),
    )
