"""SSL data preparation — a copy of heart_murmur_detection_tpu/pretrain/
prepare.py, pinned to the original by tests/test_torch_prepare.py: for the
heart corpora `_select_files` :21, `preprocess_spectrogram_ssl` :32,
`preprocess_entire_spec_files` :54 and `preprocess_spectrogram_ssl_audiomae`
:280 (the reference's src/pretrain/prepare_data/heart_pressl.py); for the
respiratory corpora `preprocess_icbhi_entire` :84, `preprocess_icbhi_cycles`
:107, `preprocess_covid19sounds_ssl` :144, `preprocess_coughvid_ssl` :206,
`preprocess_coviduk_ssl` :235 and `preprocess_hflung_ssl` :262 (the
reference's *_pressl.py scripts), their metadata read through
utils/table.py as pandas reads it.

Writes a spectrogram .npy per clip and a manifest of their names (without
`.npy`) at the paths pretrain/data.py::manifest_path reads (the
respiratory corpora under datasets/<corpus>/):
- COLA / OPERA-CT: the whole clip's (T, 64) mel (audio/pipelines.py::
  get_entire_signal, input_sec floor, f_max 8000) ->
  feature/<t>_eval/entire_spec_npy/<id>.npy, manifest
  entire_spec_filenames.npy;
- Audio-MAE: the first 10-s kaldi-fbank chunk ->
  feature/<t>_eval/audiomae_entire_spec_npy/<id>.npy, manifest
  audiomae_entire_spec_filenames.npy.
The in-domain variant reads train_test_pretrain_split.npy and keeps its
'train_pretrain' rows (names gain "_in_domain"). Clips too short for a
spectrogram are counted and skipped. Host numpy only.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..audio.pipelines import get_entire_signal, get_split_signal_fbank_pad
from ..utils.table import read_csv


def _select_files(feature_dir: str, in_domain: bool):
    sound_dir_loc = np.load(os.path.join(feature_dir, "sound_dir_loc.npy"))
    if not in_domain:
        y_set = np.load(os.path.join(feature_dir, "train_test_split.npy"))
        keep = (y_set == "train") | (y_set == "val")
    else:
        y_set = np.load(os.path.join(feature_dir, "train_test_pretrain_split.npy"))
        keep = y_set == "train_pretrain"
    return sound_dir_loc[keep]


def preprocess_spectrogram_ssl(
    feature_dir: str, input_sec: float = 8, in_domain: bool = False
) -> int:
    """The COLA manifest of a processed heart feature dir; returns the count
    of valid clips."""
    files = _select_files(feature_dir, in_domain)
    spec_dir = "entire_spec_npy" + ("_in_domain" if in_domain else "")
    base = "entire_spec" + ("_in_domain" if in_domain else "")
    out_dir = os.path.join(feature_dir, spec_dir)
    names, invalid = [], 0
    for audio_file in files:
        file_id = os.path.basename(str(audio_file))[:-4]
        data = get_entire_signal(str(audio_file), input_sec=input_sec, spectrogram=True)
        if data is None:
            invalid += 1
            continue
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, file_id + ".npy"), data)
        names.append(os.path.join(feature_dir, spec_dir, file_id))
    np.save(os.path.join(feature_dir, base + "_filenames.npy"), names)
    print(f"prepared {feature_dir}: valid {len(names)}, invalid {invalid}")
    return len(names)


def preprocess_entire_spec_files(
    files,
    out_dir: str,
    manifest_path: str,
    input_sec: float = 8,
    split_values=None,
    split_path: str = None,
) -> int:
    """Whole-clip SSL spectrograms of a file list: a mel .npy per clip under
    out_dir, their names in manifest_path, and with split_values the valid
    clips' values in split_path. Returns the count of valid clips."""
    names, keep_split, invalid = [], [], 0
    for i, audio_file in enumerate(files):
        file_id = os.path.basename(str(audio_file))[:-4]
        data = get_entire_signal(str(audio_file), input_sec=input_sec, spectrogram=True)
        if data is None:
            invalid += 1
            continue
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, file_id + ".npy"), data)
        names.append(os.path.join(out_dir, file_id))
        if split_values is not None:
            keep_split.append(split_values[i])
    np.save(manifest_path, names)
    if split_values is not None and split_path:
        np.save(split_path, keep_split)
    print(f"prepared {manifest_path}: valid {len(names)}, invalid {invalid}")
    return len(names)


def _icbhi_splits(data_dir: str):
    return read_csv(os.path.join(data_dir, "ICBHI_challenge_train_test.txt"), sep="\t",
                    names=["fileID", "group"], as_str=True).lookup("fileID", "group")


def preprocess_icbhi_entire(data_dir: str = "datasets/icbhi/", input_sec: float = 8):
    """icbhi_pressl.preprocess_entire_spectrogram: manifest + train/test split
    from the official challenge split file."""
    splits = _icbhi_splits(data_dir)
    files = sorted(glob.glob(os.path.join(data_dir, "ICBHI_final_database", "*.wav")))
    split_values = [splits.loc(os.path.basename(f)[:-4]) for f in files]
    return preprocess_entire_spec_files(
        files,
        os.path.join(data_dir, "entire_spec_npy"),
        os.path.join(data_dir, "entire_spec_filenames.npy"),
        input_sec,
        split_values,
        os.path.join(data_dir, "entire_spec_split.npy"),
    )


def preprocess_icbhi_cycles(data_dir: str = "datasets/icbhi/", input_sec: float = 2):
    """icbhi_pressl.preprocess_cycle_spectrogram: a mel per respiratory cycle
    (each recording at 16 kHz, cut at its annotation rows), padded to
    input_sec; manifest cycle_spec_pad2_name.npy, splits
    cycle_spec_split.npy."""
    from ..audio.icbhi import get_annotations, get_individual_cycles

    splits = _icbhi_splits(data_dir)
    audio_dir = os.path.join(data_dir, "ICBHI_final_database")
    ann = get_annotations("cycle", audio_dir)
    out_dir = os.path.join(data_dir, "cycle_spec_pad2_npy")
    os.makedirs(out_dir, exist_ok=True)
    names, split_vals, valid, invalid = [], [], 0, 0
    for f in sorted(glob.glob(os.path.join(audio_dir, "*.wav"))):
        fid = os.path.basename(f)[:-4]
        cycles = get_individual_cycles("cycle", ann[fid], audio_dir, fid, 16000, 2)
        for j, (audio, _label) in enumerate(cycles, start=1):
            data = get_entire_signal("", input_sec=input_sec, spectrogram=True, yt=audio)
            if data is None:
                invalid += 1
                continue
            np.save(os.path.join(out_dir, f"{fid}cycle{j}.npy"), data)
            names.append(os.path.join(out_dir, f"{fid}cycle{j}"))
            split_vals.append(splits.loc(fid))
            valid += 1
    np.save(os.path.join(data_dir, "cycle_spec_pad2_name.npy"), names)
    np.save(os.path.join(data_dir, "cycle_spec_split.npy"), split_vals)
    print("valid_data", valid, "invalid_data", invalid)
    return valid


def preprocess_covid19sounds_ssl(
    data_dir: str = "datasets/covid19-sounds/",
    modality: str = "breath",
    input_sec: float = 8,
) -> int:
    """covid19sounds_pressl.preprocess_spectrogram_SSL: quality-gated SSL prep.

    Walks the per-chunk metadata CSVs (';'-separated), keeps rows whose
    '<Modality> check' column contains the modality's letter ('c' / 'b' /
    'v'), excludes every uid in the downstream test splits (test_uid.npy +
    task1 split == 2 + task2 fold == 'test' + one known-bad uid), and writes
    <uid>_<folder>_<modality>.npy specs + a per-modality manifest
    (covid19sounds_pressl.py:14-106). A voice recording falls back to the
    '*read*' file (the corpus's naming)."""
    except_uids = set(np.load(os.path.join(data_dir, "test_uid.npy")).tolist())
    except_uids.add("MJQ296DCcN")
    t1 = read_csv(os.path.join(data_dir, "data_0426_en_task1.csv"), sep=";")
    except_uids.update(u for u, s in zip(t1["Uid"], t1["split"]) if s == 2)
    t2 = read_csv(os.path.join(data_dir, "data_0426_en_task2.csv"))
    except_uids.update(u for u, f in zip(t2["uid"], t2["fold"]) if f == "test")

    check_col = {"breath": ("Breath check", "b"), "cough": ("Cough check", "c"),
                 "voice": ("Voice check", "v")}[modality]
    out_dir = os.path.join(data_dir, "entire_spec_npy_8000")
    names, invalid = [], 0
    for meta in sorted(glob.glob(os.path.join(data_dir, "covid19_data_0426_metadata", "*.csv"))):
        df = read_csv(meta, sep=";")
        df = df.where(df.str_contains(check_col[0], check_col[1]))
        for _, row in df.iterrows():
            uid, folder = row["Uid"], row["Folder Name"]
            if uid in except_uids:
                continue
            pattern = os.path.join(
                data_dir, "covid19_data_0426", uid, folder, f"*{modality}*.wav"
            )
            hits = glob.glob(pattern)
            if not hits and modality == "voice":  # naming inconsistency
                hits = glob.glob(os.path.join(
                    data_dir, "covid19_data_0426", uid, folder, "*read*.wav"
                ))
            if not hits:
                continue
            data = get_entire_signal(hits[0], input_sec=input_sec, spectrogram=True)
            if data is None:
                invalid += 1
                continue
            os.makedirs(out_dir, exist_ok=True)
            fid = "_".join([uid, folder, modality])
            np.save(os.path.join(out_dir, fid + ".npy"), data)
            names.append(os.path.join(out_dir, fid))
    # the reference's pressl script writes a *_8000_<modality> manifest but
    # its CP consumer loads SSL_entireaudio_filenames_<modality>.npy
    # (cola_training.py:146): the name the loader reads
    np.save(
        os.path.join(data_dir, f"SSL_entireaudio_filenames_{modality}.npy"), names
    )
    print(f"covid19sounds {modality}: valid {len(names)}, invalid {invalid}")
    return len(names)


def preprocess_coughvid_ssl(
    data_dir: str = "datasets/coughvid/", input_sec: float = 2
) -> int:
    """coughvid_pressl.preprocess_spectrogram_SSL: train+val uuids from the
    gender-split writer -> whole-clip specs (coughvid_pressl.py:12-49)."""
    uids = set(
        np.load(os.path.join(data_dir, "coughvid__train_uuids.npy"),
                allow_pickle=True).tolist()
        + np.load(os.path.join(data_dir, "coughvid__val_uuids.npy"),
                  allow_pickle=True).tolist()
    )
    files = [
        os.path.join(data_dir, "wav", f)
        for f in sorted(os.listdir(os.path.join(data_dir, "wav")))
        if f.split(".")[0] in uids
    ]
    return preprocess_entire_spec_files(
        files,
        os.path.join(data_dir, "entire_spec_npy"),
        os.path.join(data_dir, "entire_spec_filenames.npy"),
        input_sec,
    )


def _flat_list(path: str):
    arr = np.load(path, allow_pickle=True).tolist()
    return [x for item in arr for x in (item if isinstance(item, (list, np.ndarray)) else [item])]


def preprocess_coviduk_ssl(
    data_dir: str = "datasets/covidUK/",
    modality: str = "exhalation",
    input_sec: float = 4,
) -> int:
    """covidUK_pressl.preprocess_spectrogram_SSL: train+val file lists (nested
    sublists flattened) -> whole-clip specs (covidUK_pressl.py:12-52)."""
    files = []
    for tag in ("training", "val"):
        for cand in (f"{modality}_{tag}_files.npy", f"{modality}_{tag}_files_downsample.npy"):
            p = os.path.join(data_dir, cand)
            if os.path.exists(p):
                files.extend(_flat_list(p))
                break
    files = [
        os.path.join(data_dir, "audio", f)
        for f in files
        if os.path.exists(os.path.join(data_dir, "audio", f))
    ]
    return preprocess_entire_spec_files(
        files,
        os.path.join(data_dir, "entire_spec_npy"),
        os.path.join(data_dir, f"entire_{modality}_filenames.npy"),
        input_sec,
    )


def preprocess_hflung_ssl(
    data_dir: str = "datasets/hf_lung/", input_sec: float = 8
) -> int:
    """hflung_pressl.preprocess_entire_spectrogram: both HF_Lung_V1 train dirs
    -> whole-clip specs + one manifest (hflung_pressl.py:12-57)."""
    files = []
    for sub in ("HF_Lung_V1-master/train", "HF_Lung_V1_IP-main/train"):
        files.extend(sorted(glob.glob(os.path.join(data_dir, sub, "*.wav"))))
    return preprocess_entire_spec_files(
        files,
        os.path.join(data_dir, "entire_spec_npy"),
        os.path.join(data_dir, "entire_spec_filenames.npy"),
        input_sec,
    )


def preprocess_spectrogram_ssl_audiomae(
    feature_dir: str, input_sec: float = 10, in_domain: bool = False
) -> int:
    """The Audio-MAE manifest of a processed heart feature dir (the first
    kaldi-fbank chunk of each clip); returns the count of valid clips."""
    files = _select_files(feature_dir, in_domain)
    spec_dir = "audiomae_entire_spec_npy" + ("_in_domain" if in_domain else "")
    base = "audiomae_entire_spec" + ("_in_domain" if in_domain else "")
    out_dir = os.path.join(feature_dir, spec_dir)
    names, invalid = [], 0
    for audio_file in files:
        file_id = os.path.basename(str(audio_file))[:-4]
        chunks = get_split_signal_fbank_pad(
            str(audio_file), input_sec=input_sec, spectrogram=True, trim_tail=False
        )
        if not chunks:
            invalid += 1
            continue
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, file_id + ".npy"), chunks[0])
        names.append(os.path.join(feature_dir, spec_dir, file_id))
    np.save(os.path.join(feature_dir, base + "_filenames.npy"), names)
    print(f"prepared (audiomae) {feature_dir}: valid {len(names)}, invalid {invalid}")
    return len(names)
