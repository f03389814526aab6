"""Clips/s of the dataset processing CLI on a synthetic CirCor corpus.

    python -m heart_murmur_detection_tpu_torch.bench.process_time [tag] [repeats] [pallas_mel]

Writes a synthetic CirCor corpus at its 4 kHz rate (write_circor) into a
temporary directory, then times `cli.process dataset=circor pretrain=operaCT
dim=768 random_init=True source_sr=4000` on the card `repeats` times (2 by
default; the first builds the kernels if they are not built), each from a
clean feature directory. Prints one line a run, prefixed by `tag`: clips,
seconds, clips/s. The wall time covers the whole CLI: the split, the model's
random init, the host decode, trim and pad at 4 kHz, and the extraction.
With `pallas_mel`, every FeatureExtractor the CLI builds takes
use_pallas_mel=True (the mel through the logmel kernel, ops/mel.py), and
the line also gives the run's logmel launches.
"""

from __future__ import annotations

import functools
import os
import shutil
import sys
import tempfile
import time
from typing import List

import numpy as np


def write_circor(root: str, patients: int = 120, seed: int = 19, sr: int = 4000) -> int:
    """A synthetic CirCor corpus in the dataset's layout at its 4 kHz rate (or sr):
    datasets/circor/{training,validation,test}_data/<pid>_<loc>.wav and
    <pid>.txt; `patients` patients (3 in 5 train, 1 validation, 1 test), 1-4
    locations each, 6-32 s clips of noise; murmur Present, Absent or Unknown
    in turn, a Present clip carrying a 150-400 Hz tone burst in each 0.8-s
    beat. Returns the number of clips."""
    from ..utils.audio_io import write_wav

    r = np.random.default_rng(seed)
    n_clips = 0
    for i in range(patients):
        split = ("training_data",) * 3 + ("validation_data", "test_data")
        d = os.path.join(root, "datasets", "circor", split[i % 5])
        os.makedirs(d, exist_ok=True)
        pid, murmur = str(50000 + i), ("Present", "Absent", "Unknown")[i % 3]
        for loc in ("AV", "MV", "PV", "TV")[: int(r.integers(1, 5))]:
            n = int(r.uniform(6, 32) * sr)
            t = np.arange(n) / sr
            x = 0.05 * r.standard_normal(n)
            if murmur == "Present":
                beat = (t % 0.8) < 0.25
                x += 0.2 * beat * np.sin(2 * np.pi * r.uniform(150, 400) * t)
            write_wav(os.path.join(d, f"{pid}_{loc}.wav"), x.astype(np.float32), sr)
            n_clips += 1
        grading = "II/VI" if murmur == "Present" else "nan"
        with open(os.path.join(d, f"{pid}.txt"), "w") as f:
            f.write(f"{pid} {n_clips} {sr}\n#Murmur: {murmur}\n"
                    f"#Outcome: {'Abnormal' if murmur == 'Present' else 'Normal'}\n"
                    f"#Systolic murmur timing: nan\n#Systolic murmur shape: nan\n"
                    f"#Systolic murmur grading: {grading}\n#Systolic murmur pitch: nan\n"
                    f"#Systolic murmur quality: nan\n")
    return n_clips


def main(argv: List[str] = None) -> int:
    from ..cli import process
    from ..extract import extract as ext
    from ..ops import mel

    argv = sys.argv[1:] if argv is None else argv
    tag = argv[0] if argv else "process"
    repeats = int(argv[1]) if len(argv) > 1 else 2
    pallas_mel = len(argv) > 2 and argv[2] == "pallas_mel"
    cwd = os.getcwd()
    fe = ext.FeatureExtractor
    if pallas_mel:  # extract_and_save looks the class up at call time
        ext.FeatureExtractor = functools.partial(fe, use_pallas_mel=True)
    with tempfile.TemporaryDirectory() as root:
        n_clips = write_circor(root)
        os.chdir(root)
        try:
            for i in range(repeats):
                shutil.rmtree("feature", ignore_errors=True)
                mel.reset_launch_counts()
                t0 = time.time()
                process.main(["dataset=circor", "pretrain=operaCT", "dim=768",
                              "random_init=True", "source_sr=4000"])
                s = time.time() - t0
                print(f"{tag} run {i}: {n_clips} clips in {s:.2f} s = {n_clips / s:.1f} clips/s"
                      f" (logmel launches {mel.launch_counts()['logmel']})", flush=True)
        finally:
            os.chdir(cwd)
            ext.FeatureExtractor = fe
    return 0


if __name__ == "__main__":
    sys.exit(main())
