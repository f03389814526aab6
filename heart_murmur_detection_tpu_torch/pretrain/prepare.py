"""SSL data preparation for the heart corpora — a copy of `_select_files`
:21, `preprocess_spectrogram_ssl` :32, `preprocess_entire_spec_files` :54
and `preprocess_spectrogram_ssl_audiomae` :280 of
heart_murmur_detection_tpu/pretrain/prepare.py (the reference's
src/pretrain/prepare_data/heart_pressl.py), pinned to the original by
tests/test_torch_prepare.py.

Writes a spectrogram .npy per clip and a manifest of their names (without
`.npy`) at the paths pretrain/data.py::manifest_path reads:
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

import os

import numpy as np

from ..audio.pipelines import get_entire_signal, get_split_signal_fbank_pad


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
