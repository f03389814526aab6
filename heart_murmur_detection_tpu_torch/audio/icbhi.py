"""ICBHI respiratory-cycle utilities — a copy of
heart_murmur_detection_tpu/audio/icbhi.py (`extract_lungsound_annotation`
:19, `get_annotations` :40, `get_lungsound_label`, `get_diagnosis_label`,
`slice_seconds`, `get_individual_cycles` :100; the reference's
src/util.py:54-110, 129-138, 374-478), pinned to the original by
tests/test_torch_legacy.py.

Parses the per-recording annotation txts, slices respiratory cycles out of
the waveform, and maps (crackles, wheezes) / diagnosis strings to 4 / 2 /
3-class labels. The diagnosis file is read as pandas reads it
(utils/table.py: dtype=str, tab-separated, no header).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.audio_io import load_wav
from ..utils.table import read_csv


def extract_lungsound_annotation(file_name: str, data_folder: str):
    """Rows of (start, end, crackles, wheezes) from <file>.txt; recording info
    tokens from the filename (patient, index, location, mode, equipment)."""
    tokens = file_name.strip().split("_")
    info = dict(
        zip(
            ["patient", "recording_index", "chest_location", "acquisition_mode", "equipment"],
            tokens,
        )
    )
    rows = []
    with open(os.path.join(data_folder, file_name + ".txt")) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) >= 4:
                rows.append(
                    (float(parts[0]), float(parts[1]), int(parts[2]), int(parts[3]))
                )
    return info, rows


def get_annotations(
    class_split: str = "cycle",
    data_folder: str = "datasets/icbhi/ICBHI_final_database/",
    diagnosis_file: str = "datasets/icbhi/ICBHI_Challenge_diagnosis.txt",
) -> Dict[str, list]:
    """cycle: {recording: [(start, end, crackles, wheezes)]};
    diagnosis: {recording: [(start, end, disease)]}."""
    filenames = sorted(
        f[:-4] for f in os.listdir(data_folder) if f.endswith(".wav")
    )
    out = {}
    if class_split == "cycle":
        for f in filenames:
            _, rows = extract_lungsound_annotation(f, data_folder)
            out[f] = rows
        return out
    if class_split == "diagnosis":
        diag = read_csv(diagnosis_file, sep="\t", names=["userID", "Disease"],
                        as_str=True).lookup("userID", "Disease")
        for f in filenames:
            _, rows = extract_lungsound_annotation(f, data_folder)
            disease = diag.loc(f.split("_")[0])
            out[f] = [(s, e, disease) for (s, e, _, _) in rows]
        return out
    raise ValueError(class_split)


def get_lungsound_label(crackle: int, wheeze: int, n_cls: int) -> Optional[int]:
    """(crackles, wheezes) -> {normal, crackle, wheeze, both} / binary
    (src/util.py:447-462)."""
    if n_cls == 4:
        return {(0, 0): 0, (1, 0): 1, (0, 1): 2, (1, 1): 3}[(crackle, wheeze)]
    if n_cls == 2:
        return 0 if (crackle == 0 and wheeze == 0) else 1
    raise ValueError(n_cls)


def get_diagnosis_label(disease: str, n_cls: int) -> Optional[int]:
    """(src/util.py:465-478)."""
    if n_cls == 3:
        if disease in ("COPD", "Bronchiectasis", "Asthma"):
            return 1
        if disease in ("URTI", "LRTI", "Pneumonia", "Bronchiolitis"):
            return 2
        return 0
    if n_cls == 2:
        return 0 if disease == "Healthy" else 1
    raise ValueError(n_cls)


def slice_seconds(data: np.ndarray, start: float, end: float, sr: int) -> np.ndarray:
    """_slice_data_librosa (src/util.py:129-138)."""
    a = min(int(start * sr), len(data))
    b = min(int(end * sr), len(data))
    return data[a:b]


def get_individual_cycles(
    class_split: str,
    annotations: list,
    data_folder: str,
    filename: str,
    sample_rate: int,
    n_cls: int,
) -> List[Tuple[np.ndarray, int]]:
    """Slice one recording into per-cycle (waveform, label) pairs
    (src/util.py:374-422), without the reference's optional bandpass filter,
    which no caller sets."""
    data, rate = load_wav(os.path.join(data_folder, filename + ".wav"), sr=sample_rate)
    out = []
    for row in annotations:
        start, end = row[0], row[1]
        chunk = slice_seconds(data, start, end, rate)
        if class_split == "cycle":
            label = get_lungsound_label(row[2], row[3], n_cls)
        else:
            label = get_diagnosis_label(row[2], n_cls)
        out.append((chunk, label))
    return out
