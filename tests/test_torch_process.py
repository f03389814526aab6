"""The port's dataset processors and their numpy splits (CPU) against the JAX
package and sklearn, and the main path end to end on the CPU: cli.process
(at CirCor's 4 kHz source rate) then cli.linear_eval, with the JAX probe
reading the port's feature file."""

import os

import numpy as np
import pytest
import torch
from sklearn.model_selection import StratifiedKFold
from sklearn.model_selection import train_test_split as sk_train_test_split

from heart_murmur_detection_tpu.data.processors import circor as jcircor
from heart_murmur_detection_tpu.data.processors import pascal as jpascal
from heart_murmur_detection_tpu.data.processors import physionet16 as jphysionet16
from heart_murmur_detection_tpu.data.processors import zchsound as jzchsound
from heart_murmur_detection_tpu.train.linear_eval import linear_evaluation_heart as jlinear_eval
from heart_murmur_detection_tpu_torch.cli import linear_eval as cli_linear_eval
from heart_murmur_detection_tpu_torch.cli import process as cli_process
from heart_murmur_detection_tpu_torch.data import splits
from heart_murmur_detection_tpu_torch.data.processors import circor, pascal, physionet16, zchsound
from heart_murmur_detection_tpu_torch.data.processors.common import extract_and_save
from heart_murmur_detection_tpu_torch.utils.audio_io import write_wav


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", range(6))
def test_splits_match_sklearn(case):
    r = np.random.default_rng(case)
    n, k = int(r.integers(20, 300)), int(r.integers(2, 5))
    y = np.arange(n) % k
    r.shuffle(y)
    files = [f"f{i}.wav" for i in range(n)]
    for ts in (0.2, 0.5):
        seed = int(r.integers(0, 2000))
        want = sk_train_test_split(files, list(y), test_size=ts, random_state=seed, stratify=y)
        got = splits.train_test_split(files, list(y), test_size=ts, random_state=seed, stratify=y)
        assert [list(a) for a in got] == [list(a) for a in want]
        assert (splits.train_test_split(np.array(files), test_size=ts, random_state=seed)[0].tolist()
                == sk_train_test_split(np.array(files), test_size=ts, random_state=seed)[0].tolist())
    folds = StratifiedKFold(5, shuffle=True, random_state=case).split(np.zeros(n), y)
    for (a, b), (c, d) in zip(folds, splits.stratified_kfold(y, 5, case)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def _wav(path, sec=2.0, seed=0, sr=4000, tone=None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    r = np.random.default_rng(seed)
    x = 0.2 * r.standard_normal(int(sec * sr))
    if tone:
        x += 0.3 * np.sin(2 * np.pi * tone * np.arange(len(x)) / sr)
    write_wav(path, x.astype(np.float32), sr)


CIRCOR_INFO = {
    "100": ("Present", "Abnormal", "Holosystolic", "Plateau", "I/VI", "Low", "Harsh"),
    "101": ("Absent", "Normal", "nan", "nan", "nan", "nan", "nan"),
    "102": ("Unknown", "Abnormal", "nan", "nan", "nan", "nan", "nan"),
}


def _circor_txt(path, m, o, t, s, g, p, q):
    with open(path, "w") as f:
        f.write(f"#Murmur: {m}\n#Outcome: {o}\n#Systolic murmur timing: {t}\n"
                f"#Systolic murmur shape: {s}\n#Systolic murmur grading: {g}\n"
                f"#Systolic murmur pitch: {p}\n#Systolic murmur quality: {q}\n")


def _circor(root):
    """tests/test_processors.py's CirCor tree, plus a training_data.csv."""
    data = os.path.join(root, "circor")
    for d, pids in [("training_data", ["100", "101", "102"]), ("test_data", ["102"]),
                    ("validation_data", [])]:
        os.makedirs(os.path.join(data, d), exist_ok=True)
        for pid in pids:
            for loc in ("AV", "MV"):
                _wav(os.path.join(data, d, f"{pid}_{loc}.wav"), seed=int(pid))
            _circor_txt(os.path.join(data, d, f"{pid}.txt"), *CIRCOR_INFO[pid])
    # the CSV lists 15 patients (murmur in column 7, outcome in 20): the
    # stratified 64/16/20 split needs each class in the test part
    rows = ["id,locs," + ",".join(f"c{i}" for i in range(2, 21))]
    for i in range(15):
        m, o = CIRCOR_INFO[str(100 + i % 3)][:2]
        cols = ["x"] * 19
        cols[5], cols[18] = m, o
        rows.append(f"{100 + i},AV+MV," + ",".join(cols))
    with open(os.path.join(data, "training_data.csv"), "w") as f:
        f.write("\n".join(rows))
    return data


def _pascal(root):
    data = os.path.join(root, "PASCAL")
    n = 0
    for d in pascal.DIRS["A"]:
        for _ in range(10):
            _wav(os.path.join(data, d, f"x{n}.wav"), seed=n)
            n += 1
    return data


def _zchsound(root):
    data = os.path.join(root, "ZCH") + "/"
    rows = []
    for i, dg in enumerate(["ASD", "NORMAL", "PDA", "PFO", "VSD"] * 6):
        _wav(os.path.join(data, "clean Heartsound Data", f"p{i}.wav"), seed=i)
        rows.append(f"p{i}.wav;x;y;{dg};z")
    with open(data + "Clean Heartsound Data Details.csv", "w") as f:
        f.write("id;a;b;diag;c\n" + "\n".join(rows))
    return data


def _physionet16(root):
    data = os.path.join(root, "phys") + "/"
    n = 0
    for d in physionet16.TRAINING_DIRS:
        os.makedirs(os.path.join(data, "annotations/updated", d), exist_ok=True)
        ann_rows = []
        for _ in range(6):
            base, lab = f"r{n}", "normal" if n % 2 == 0 else "abnormal"
            _wav(os.path.join(data, d, base + ".wav"), seed=n)
            with open(os.path.join(data, d, base + ".hea"), "w") as f:
                f.write(f"{base} 1 2000 8000\n#{lab}\n")
            ann_rows.append(f"{base},{1 if lab == 'abnormal' else -1},{n % 2}")
            n += 1
        with open(os.path.join(data, "annotations/updated", d, "REFERENCE_withSQI.csv"), "w") as f:
            f.write("\n".join(ann_rows))
    return data


PROCESSORS = {
    "circor_read_data": (_circor, lambda m, d, f: m.read_data(d, f), jcircor, circor),
    "circor_preprocess_split": (_circor, lambda m, d, f: m.preprocess_split(d, f), jcircor, circor),
    "pascal_A": (_pascal, lambda m, d, f: m.preprocess_split("A", d, f), jpascal, pascal),
    "zchsound_clean": (_zchsound, lambda m, d, f: m.preprocess_split("clean", d, f),
                       jzchsound, zchsound),
    "physionet16_independent": (_physionet16, lambda m, d, f: m.preprocess_split_independent(d, f),
                                jphysionet16, physionet16),
    "physionet16_stratified": (_physionet16, lambda m, d, f: m.preprocess_split(d, f),
                               jphysionet16, physionet16),
}


@pytest.mark.parametrize("name", sorted(PROCESSORS))
def test_processor_files_identical(name, tmp_path):
    """Every .npy and .json the port's processor writes is the JAX package's."""
    make, run, jmod, tmod = PROCESSORS[name]
    data = make(str(tmp_path))
    out = {}
    for tag, mod in (("jax", jmod), ("torch", tmod)):
        fdir = str(tmp_path / f"feat_{tag}") + "/"
        os.makedirs(fdir)
        run(mod, data, fdir)
        out[tag] = fdir
    names = sorted(os.listdir(out["jax"]))
    assert names == sorted(os.listdir(out["torch"])) and len(names) >= 3
    for f in names:
        a, b = out["jax"] + f, out["torch"] + f
        if f.endswith(".npy"):
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), f


def test_baseline_encoders_raise(tmp_path):
    np.save(tmp_path / "sound_dir_loc.npy", np.array(["x.wav"]))
    with pytest.raises(NotImplementedError, match="not ported"):
        extract_and_save(str(tmp_path), "vggish", device="cpu")


def _circor_corpus(root):
    """A CirCor-layout corpus at 4 kHz: 12 patients, one location each,
    murmur Present (a 150 Hz tone), Absent or Unknown; six train, three
    validation and three test patients, every split with all three classes."""
    murmurs = ["Present", "Absent", "Unknown"]
    for i in range(12):
        d = ("training_data" if i < 6 else "validation_data" if i < 9 else "test_data")
        pid, m = str(200 + i), murmurs[i % 3]
        base = os.path.join(root, "datasets", "circor", d)
        _wav(os.path.join(base, f"{pid}_AV.wav"), sec=2.0 + 0.5 * i, seed=i,
             tone=150 if m == "Present" else None)
        _circor_txt(os.path.join(base, f"{pid}.txt"), m, "Normal", "nan", "nan", "nan", "nan",
                    "nan")


def test_cli_process_then_linear_eval_on_cpu(tmp_path, monkeypatch):
    """The main path on the CPU: cli.process ships the 4 kHz clips at their
    source rate (device upsample) and writes operaCT768_feature.npy; then
    cli.linear_eval runs the seed protocol on it (2 seeds here), and the
    JAX package's probe reads the same file."""
    _circor_corpus(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    (out,) = cli_process.main(["dataset=circor", "pretrain=operaCT", "dim=768",
                               "random_init=True", "source_sr=4000", "device=cpu"])
    assert out == "feature/circor_eval/operaCT768_feature.npy"
    feats = np.load(out)
    assert feats.shape == (12, 768) and np.isfinite(feats).all()
    ((s0, s1),) = cli_linear_eval.main(["task=circor_murmurs", "pretrain=operaCT", "dim=768",
                                        "n_run=2", "device=cpu"])
    assert np.isfinite([s0, s1]).all() and 0 <= min(s0, s1) <= max(s0, s1) <= 1
    assert len(os.listdir("cks/linear/circor_murmurs")) == 2
    res = jlinear_eval(seed=0, use_feature="operaCT768", loss="weighted",
                       feature_dir="feature/circor_eval/", labels_filename="murmurs.npy")
    assert np.isfinite(res.test_auc)


@pytest.mark.parametrize("argv,match", [
    (["task=circor_murmurs", "LOOCV=True"], "LOOCV"),
    (["task=icbhidisease"], "legacy task"),
])
def test_linear_eval_cli_refuses_unported_tasks(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        cli_linear_eval.main(argv + ["device=cpu"])
