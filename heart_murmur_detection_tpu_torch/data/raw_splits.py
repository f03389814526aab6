"""Raw-data split writers — a copy of heart_murmur_detection_tpu/data/
raw_splits.py (`coughvid_build_splits` :15, `coviduk_build_splits` :53,
`hflung_build_metadata` :88; the reference's datasets_old/ one-off
scripts), pinned to the original by tests/test_torch_legacy.py.

They write the published split artifacts that the respiratory processors
and SSL preparers read. pandas is replaced by utils/table.py, pandas'
`DataFrame.sample(n, random_state=0)` by RandomState(0).choice(len, n,
replace=False) (what pandas draws), and sklearn's train_test_split by
data/splits.py.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..utils.table import Frame, merge_inner, read_csv
from .splits import split_indices


def _sample(frame: Frame, n: int, seed: int) -> Frame:
    """frame.sample(n=n, random_state=seed)."""
    return frame.take(np.random.RandomState(seed).choice(len(frame), size=n, replace=False))


def _values(frame: Frame, col: str) -> np.ndarray:
    """frame[col].values as np.save stores it (a str column as objects)."""
    vals = frame[col]
    return np.array(vals, dtype=object) if frame.kinds[col] == "str" else np.array(vals)


def _concat(a: Frame, b: Frame) -> Frame:
    return Frame({c: a[c] + b[c] for c in a.columns}, a.kinds)


def coughvid_build_splits(
    data_dir: str = "datasets/coughvid/",
    n_female_test: int = 1031,
    n_male_test: int = 1924,
    n_healthy_covid_test: int = 2237,
    n_covid_test: int = 172,
):
    """datasets_old/coughvid_split.py: gate on cough_detected >= 0.8; fixed-size
    gender-balanced test (seed 0); 75/25 train/val of the rest (seed 100);
    separate covid test subset sampled from the gender test set (seed 0)."""
    df = read_csv(os.path.join(data_dir, "metadata_compiled.csv"))
    df = df.where([v >= 0.8 for v in df["cough_detected"]])

    female_test = _sample(df.where([g == "female" for g in df["gender"]]), n_female_test, 0)
    male_test = _sample(df.where([g == "male" for g in df["gender"]]), n_male_test, 0)
    test = _concat(female_test, male_test)
    test_set = set(test["uuid"])
    train_val = df.where([u not in test_set for u in df["uuid"]])
    tr, va = split_indices(len(train_val), 0.25, 100)
    train, val = train_val.take(tr), train_val.take(va)

    np.save(os.path.join(data_dir, "coughvid__train_uuids.npy"), _values(train, "uuid"))
    np.save(os.path.join(data_dir, "coughvid__val_uuids.npy"), _values(val, "uuid"))
    np.save(os.path.join(data_dir, "coughvid_gender_test_uuids.npy"), _values(test, "uuid"))

    test_df = df.where([u in test_set for u in df["uuid"]])
    healthy = _sample(test_df.where([s == "healthy" for s in test_df["status"]]),
                      n_healthy_covid_test, 0)
    covid = _sample(test_df.where([s == "COVID-19" for s in test_df["status"]]), n_covid_test, 0)
    np.save(os.path.join(data_dir, "coughvid_covid_test_uuids.npy"),
            _values(_concat(healthy, covid), "uuid"))
    return len(train), len(val), len(test)


def coviduk_build_splits(
    data_dir: str = "datasets/covidUK/", downsample_factor: int = 1
):
    """datasets_old/covidUK_split.py: per-modality file lists from the official
    participant train/val/test splits (train_test_splits.csv). The published
    *_downsample.npy variants subsample trains; factor=1 keeps all."""
    participant = read_csv(os.path.join(data_dir, "audio_metadata.csv"))
    split = read_csv(os.path.join(data_dir, "train_test_splits.csv"))
    merged = merge_inner(participant, split, "participant_identifier")

    for modality in ("exhalation", "cough"):
        buckets: Dict[str, list] = {"train": [], "val": [], "test": []}
        col = f"{modality}_file_name"
        for _, row in merged.iterrows():
            s = row["splits"]
            if s in buckets and isinstance(row[col], str):
                buckets[s].append(row[col])
        if downsample_factor > 1:
            buckets["train"] = buckets["train"][::downsample_factor]
        np.save(
            os.path.join(data_dir, f"{modality}_training_files_downsample.npy"),
            np.array(buckets["train"], dtype=object),
        )
        np.save(
            os.path.join(data_dir, f"{modality}_val_files_downsample.npy"),
            np.array(buckets["val"], dtype=object),
        )
        np.save(
            os.path.join(data_dir, f"{modality}_testing_files_downsample.npy"),
            np.array(buckets["test"], dtype=object),
        )


def hflung_build_metadata(data_dir: str = "datasets/hf_lung/HF_Lung_V1-master/"):
    """datasets_old/hf_lung/hflung_split.py: label each recording from its
    annotation txt (Wheeze/Stridor/Rhonchi/Both/None) into metadata.csv."""
    rows = ["filename,split,label"]
    for split in ("train", "test"):
        path = os.path.join(data_dir, split)
        if not os.path.isdir(path):
            continue
        for f in sorted(os.listdir(path)):
            if not f.endswith(".txt"):
                continue
            content = open(os.path.join(path, f)).read()
            flags = [k for k in ("Wheeze", "Stridor", "Rhonchi") if k in content]
            label = "Both" if len(flags) > 1 else (flags[0] if flags else "None")
            rows.append(f"{f.split('.')[0][:-6]},{split},{label}")
    out = os.path.join(os.path.dirname(data_dir.rstrip("/")), "metadata.csv")
    with open(out, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    return out
