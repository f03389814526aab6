"""Legacy OPERA respiratory dataset processors — a copy of
heart_murmur_detection_tpu/data/processors/respiratory.py (the reference's
copd / kauh / icbhi / ssbpr / nosemic / mmlung / coughvid / coviduk /
covid19sounds / coswara processing scripts), pinned to the original by
tests/test_torch_legacy.py: every saved array equal.

Each writes the feature-dir artifacts its probe function
(train/legacy_tasks.py) reads. pandas' readers are utils/table.py (the same
column types, NaN cells and repeated-key lookups), sklearn's
train_test_split is data/splits.py's numpy copy.
"""

from __future__ import annotations

import csv
import glob
import os
from typing import Dict

import numpy as np

from ...utils.table import is_na, read_csv, read_excel
from ..splits import train_test_split


def _replace_nan(value):
    """df.replace(np.nan, "", regex=True) on one cell."""
    return "" if is_na(value) else value


# ---------------------------------------------------------------------------
# COPD — RespiratoryDatabase@TR (copd_processing.py)
# ---------------------------------------------------------------------------


def copd_preprocess_split(
    data_dir: str = "datasets/copd/", feature_dir: str = "feature/copd_eval/"
):
    """Patient-independent 64/16/20 split seed 1337; label = severity int from
    Labels.csv ('COPD<n>' last char)."""
    label_dict: Dict[str, int] = {}
    with open(os.path.join(data_dir, "Labels.csv")) as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            label_dict[row[0]] = int(row[1][-1])
    pids = list(label_dict.keys())
    labs = [label_dict[p] for p in pids]
    _xt, x_test, _yt, _ = train_test_split(
        pids, labs, test_size=0.2, random_state=1337, stratify=labs
    )
    x_train, x_val, _, _ = train_test_split(
        _xt, _yt, test_size=0.2, random_state=1337, stratify=_yt
    )
    tr, va = set(x_train), set(x_val)
    files = np.array(sorted(glob.glob(os.path.join(data_dir, "RespiratoryDatabase@TR", "*.wav"))))
    os.makedirs(feature_dir, exist_ok=True)
    np.save(os.path.join(feature_dir, "sound_dir_loc.npy"), files)
    splits, labels = [], []
    for f in files:
        u = os.path.basename(f)[:4]
        splits.append("train" if u in tr else "val" if u in va else "test")
        labels.append(label_dict[u])
    np.save(os.path.join(feature_dir, "train_test_split.npy"), splits)
    np.save(os.path.join(feature_dir, "labels.npy"), np.array(labels))


# ---------------------------------------------------------------------------
# KAUH (kauh_processing.py)
# ---------------------------------------------------------------------------


def kauh_preprocess(
    audio_dir: str = "datasets/KAUH/AudioFiles/",
    feature_dir: str = "feature/kauh_eval/",
):
    """Subset to healthy/asthma/COPD by filename token; subject-level 70/10/20
    split seed 42 — NB the reference maps val subjects into 'test' in the saved
    split (kauh_processing.py:82-87), which is kept."""
    files = np.array(sorted(glob.glob(os.path.join(audio_dir, "*.wav"))))
    subset, labels = [], []
    for f in files:
        tok = os.path.basename(f).split(",")[0].split("_")[-1]
        if tok == "N":
            lab = "healthy"
        elif "asthma" in tok or "Asthma" in tok:
            lab = "asthma"
        elif "COPD" in tok:
            lab = "COPD"
        else:
            continue
        subset.append(f)
        labels.append(lab)
    os.makedirs(feature_dir, exist_ok=True)
    np.save(os.path.join(feature_dir, "sound_dir_loc_subset.npy"), subset)
    np.save(os.path.join(feature_dir, "labels_both.npy"), labels)

    uids, ulabs = [], []
    for f, lab in zip(subset, labels):
        uid = os.path.basename(f).split("_")[0][2:]
        if uid not in uids:
            uids.append(uid)
            ulabs.append(lab)
    _xt, x_test, _yt, _ = train_test_split(
        uids, ulabs, test_size=0.2, random_state=42, stratify=ulabs
    )
    x_train, x_val, _, _ = train_test_split(
        _xt, _yt, test_size=0.1 / 0.8, random_state=42, stratify=_yt
    )
    tr = set(x_train)
    splits = [
        "train" if os.path.basename(f).split("_")[0][2:] in tr else "test"
        for f in subset
    ]
    np.save(os.path.join(feature_dir, "train_test_split.npy"), splits)


# ---------------------------------------------------------------------------
# ICBHI disease (icbhi_processing.py)
# ---------------------------------------------------------------------------


def icbhi_process_disease(
    data_dir: str = "datasets/icbhi/",
    feature_dir: str = "feature/icbhidisease_eval/",
):
    """Labels from ICBHI_Challenge_diagnosis.txt by userID; official challenge
    train/test split from ICBHI_challenge_train_test.txt."""
    diag = read_csv(os.path.join(data_dir, "ICBHI_Challenge_diagnosis.txt"), sep="\t",
                    names=["userID", "class"], as_str=True).lookup("userID", "class")
    split = read_csv(os.path.join(data_dir, "ICBHI_challenge_train_test.txt"), sep="\t",
                     names=["fileID", "group"], as_str=True).lookup("fileID", "group")

    files = np.array(sorted(glob.glob(os.path.join(data_dir, "ICBHI_final_database", "*.wav"))))
    labels, splits = [], []
    for f in files:
        fid = os.path.basename(f).split(".")[0]
        uid = fid.split("_")[0]
        labels.append(diag.loc(uid))
        splits.append(split.loc(fid))
    os.makedirs(feature_dir, exist_ok=True)
    np.save(os.path.join(feature_dir, "sound_dir_loc.npy"), files)
    np.save(os.path.join(feature_dir, "labels.npy"), labels)
    np.save(os.path.join(feature_dir, "split.npy"), splits)


# ---------------------------------------------------------------------------
# SSBPR snoring (ssbpr_processing.py)
# ---------------------------------------------------------------------------


def ssbpr_preprocess(
    data_dir: str = "datasets/SSBPR/", feature_dir: str = "feature/snoring_eval/"
):
    """Body-position label = last digit of the filename stem; label 5 dropped."""
    files = np.array(sorted(glob.glob(os.path.join(data_dir, "*", "*", "*.wav"))))
    labels, keep = [], []
    for f in files:
        lab = int(os.path.basename(f).split(".")[0][-1])
        if lab == 5:
            continue
        labels.append(lab)
        keep.append(f)
    os.makedirs(feature_dir, exist_ok=True)
    np.save(os.path.join(feature_dir, "labels.npy"), labels)
    np.save(os.path.join(feature_dir, "sound_dir_loc.npy"), keep)


# ---------------------------------------------------------------------------
# NoseMic respiratory rate (nosemic_processing.py)
# ---------------------------------------------------------------------------


def nosemic_process_label(
    data_dir: str = "datasets/nosemic/audio/",
    feature_dir: str = "feature/nosemic_eval/",
):
    """uid + target rate parsed from 'user_x_y_label.wav' filenames."""
    labels, uids, files = [], [], []
    for fn in sorted(os.listdir(data_dir)):
        user, _, _, label = fn[:-4].split("_")
        labels.append(label)
        uids.append(user)
        files.append(os.path.join(data_dir, fn))
    os.makedirs(feature_dir, exist_ok=True)
    np.save(os.path.join(feature_dir, "labels.npy"), np.array(labels))
    np.save(os.path.join(feature_dir, "uids.npy"), np.array(uids))
    np.save(os.path.join(feature_dir, "sound_dir_loc.npy"), np.array(files))


# ---------------------------------------------------------------------------
# MMLung spirometry (mmlung_processing.py)
# ---------------------------------------------------------------------------


def mmlung_process_label(
    meta_dir: str = "datasets/mmlung/", feature_dir: str = "feature/mmlung_eval/"
):
    """(n, 3) FVC / FEV1 / FEV1:FVC targets from All_path.xlsx."""
    df = read_excel(os.path.join(meta_dir, "All_path.xlsx"))
    labels = np.array([list(df[c]) for c in ["FVC", "FEV1", "FEV1/FVC"]]).T
    os.makedirs(feature_dir, exist_ok=True)
    np.save(os.path.join(feature_dir, "label.npy"), labels)


def mmlung_sound_dirs(meta_dir: str = "datasets/mmlung/"):
    df = read_excel(os.path.join(meta_dir, "All_path.xlsx"))
    out = {}
    for modality in ["Deep_Breath_file", "O_Single_file"]:
        paths = ["datasets/mmlung" + p[1:] for p in df[modality]]
        out[modality] = paths
    return out


# ---------------------------------------------------------------------------
# CoughVID (coughvid_processing.py)
# ---------------------------------------------------------------------------


def coughvid_preprocess_label(
    label: str = "covid",
    data_dir: str = "datasets/coughvid/",
    feature_dir: str = "feature/coughvid_eval/",
):
    """Labels from metadata_compiled.csv; split membership from the published
    uuid lists (coughvid__{train,val}_uuids.npy etc.)."""
    train_uuid = set(np.load(data_dir + "coughvid__train_uuids.npy", allow_pickle=True))
    val_uuid = set(np.load(data_dir + "coughvid__val_uuids.npy", allow_pickle=True))
    test_key = "covid" if label == "covid" else "gender"
    test_uuid = set(
        np.load(data_dir + f"coughvid_{test_key}_test_uuids.npy", allow_pickle=True)
    )
    all_uuid = train_uuid | val_uuid | test_uuid

    df = read_csv(data_dir + "metadata_compiled.csv")
    gender_map = {"female": 1, "male": 0}
    covid_map = {"COVID-19": 1, "healthy": 0}
    files, labs, splits = [], [], []
    for uuid, row in df.iterrows("uuid"):
        fname = data_dir + "wav/" + uuid + ".wav"
        if not os.path.exists(fname):
            fname = data_dir + "wav/" + uuid[:-1] + ".wav"
        v = (gender_map if label == "gender" else covid_map).get(
            _replace_nan(row["gender" if label == "gender" else "status"])
        )
        if v is None or uuid not in all_uuid:
            continue
        labs.append(v)
        files.append(fname)
        splits.append(
            "train" if uuid in train_uuid else "val" if uuid in val_uuid else "test"
        )
    os.makedirs(feature_dir, exist_ok=True)
    np.save(feature_dir + f"label_{label}.npy", labs)
    np.save(feature_dir + f"sound_dir_loc_{label}.npy", files)
    np.save(feature_dir + f"split_{label}.npy", splits)


# ---------------------------------------------------------------------------
# COVID-19 Sounds UK (coviduk_processing.py)
# ---------------------------------------------------------------------------


def coviduk_process_label(
    modality: str = "exhalation",
    data_dir: str = "datasets/covidUK/",
    feature_dir: str = "feature/coviduk_eval/",
):
    train_files = set(
        np.load(data_dir + f"{modality}_training_files_downsample.npy", allow_pickle=True)
    )
    val_files = set(
        np.load(data_dir + f"{modality}_val_files_downsample.npy", allow_pickle=True)
    )
    test_files = set(
        np.load(data_dir + f"{modality}_testing_files_downsample.npy", allow_pickle=True)
    )
    all_files = train_files | val_files | test_files

    col = 1 if modality == "exhalation" else 9
    audio_to_user = {}
    with open(data_dir + "audio_metadata.csv") as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            audio_to_user[row[col]] = row[0]
    users = read_csv(data_dir + "participant_metadata.csv").lookup(
        "participant_identifier", "covid_test_result")
    label_map = {"Negative": 0, "Positive": 1}
    files, labs, splits = [], [], []
    for fname in sorted(all_files):
        result = users.loc(audio_to_user[fname])
        if isinstance(result, np.ndarray):  # a repeated participant: pandas gives a Series
            raise TypeError(f"unhashable result column of a repeated participant: {result}")
        labs.append(label_map[result])
        files.append(data_dir + "audio_selected/" + fname)
        splits.append(
            "train" if fname in train_files else "val" if fname in val_files else "test"
        )
    os.makedirs(feature_dir, exist_ok=True)
    np.save(feature_dir + f"label_{modality}.npy", labs)
    np.save(feature_dir + f"sound_dir_loc_{modality}.npy", files)
    np.save(feature_dir + f"split_{modality}.npy", splits)


# ---------------------------------------------------------------------------
# COVID-19 Sounds task 1 (covid19sounds_processing.py)
# ---------------------------------------------------------------------------


def covid19sounds_preprocess_task1(
    modality: str = "cough",
    data_dir: str = "datasets/covid19-sounds/",
    feature_dir: str = "feature/covid19sounds_eval/",
):
    df = read_csv(data_dir + "data_0426_en_task1.csv", sep=";")
    labels, splits, files = [], [], []
    for _, row in df.iterrows():
        user = row["Uid"]
        if str(user)[:4] == "2020":
            user = "form-app-users"
        files.append(
            "/".join([data_dir.rstrip("/") + "/0426_EN_used_task1", str(user),
                      str(row["Folder Name"]), str(row[f"{modality.capitalize()} filename"])])
        )
        labels.append(row["label"])
        splits.append(row["split"])
    os.makedirs(feature_dir, exist_ok=True)
    np.save(feature_dir + "labels.npy", np.array(labels))
    np.save(feature_dir + "data_split.npy", np.array(splits))
    np.save(feature_dir + f"sound_dir_loc_{modality}.npy", np.array(files))


def covid19sounds_task1_downsample(
    feature_dir: str = "feature/covid19sounds_eval/", factor: int = 5
):
    """Train-set 1-in-5 downsampling into downsampled/ (covid19sounds
    task1_downsample)."""
    out = os.path.join(feature_dir, "downsampled/")
    os.makedirs(out, exist_ok=True)
    labels = np.load(feature_dir + "labels.npy")
    splits = np.load(feature_dir + "data_split.npy")
    tr, va, te = splits == 0, splits == 1, splits == 2
    new_labels = np.concatenate([labels[tr][::factor], labels[va], labels[te]])
    np.save(out + "labels.npy", new_labels)
    new_splits = np.concatenate(
        [np.zeros_like(labels[tr][::factor]), splits[va], splits[te]]
    )
    np.save(out + "data_split.npy", new_splits)
    for modality in ["cough", "breath"]:
        p = feature_dir + f"sound_dir_loc_{modality}.npy"
        if os.path.exists(p):
            sdl = np.load(p)
            np.save(
                out + f"sound_dir_loc_{modality}.npy",
                np.concatenate([sdl[tr][::factor], sdl[va], sdl[te]]),
            )


# ---------------------------------------------------------------------------
# Coswara (coswara_processing.py)
# ---------------------------------------------------------------------------

COSWARA_MODALITIES = ["breathing-deep", "breathing-shallow", "cough-heavy", "cough-shallow"]


def coswara_preprocess_label(
    label: str = "sex",
    data_dir: str = "datasets/Coswara-Data/",
    feature_dir: str = "feature/coswara_eval/",
    excluded_uuids=("C7Km0KttQRMMM6UoyocajfgZAOB3", "kgjTguvo3vZJTO7F1qO9GxEicbA3"),
):
    """Per-modality filename/label lists from combined_data.csv, quality-gated
    by the per-modality annotation CSVs (coswara_processing.py:41-104)."""
    df = read_csv(data_dir + "combined_data.csv")
    sex_map = {"female": 1, "male": 0}
    smoker_map = {"y": 1, "n": 0, "TRUE": 1, "True": 1, "False": 0, "FALSE": 0}

    os.makedirs(feature_dir, exist_ok=True)
    for modality in COSWARA_MODALITIES:
        ann = {}
        with open(data_dir + f"annotations/{modality}_labels.csv") as f:
            reader = csv.reader(f)
            next(reader)
            for row in reader:
                ann[row[0]] = row[1]
        labs, files = [], []
        for uuid, row in df.iterrows("id"):
            if uuid in excluded_uuids:
                continue
            if ann.get("_".join([uuid, modality])) == "0":
                continue  # bad quality
            matches = glob.glob(
                os.path.join(data_dir, "Extracted_data", "*", uuid, modality + ".wav")
            )
            if not matches:
                continue
            v = (sex_map if label == "sex" else smoker_map).get(
                _replace_nan(row["g" if label == "sex" else "smoker"])
            )
            if v is None:
                continue
            labs.append(v)
            files.append(matches[0])
        np.save(feature_dir + f"{label}_label_{modality}.npy", labs)
        np.save(
            feature_dir + f"entireaudio_filenames_{modality}_w_{label}.npy", files
        )
