"""The port's SSL data preparation (pretrain/prepare.py) against the JAX
package's pretrain/prepare.py on one synthetic CirCor-like feature dir:
the same manifests, element for element once the feature dir is taken off
the names, and the same spectrograms to 1e-6; the in-domain variant; and
the port's pretrain/data.py reading the manifest the port wrote."""

import os

import numpy as np
import pytest

from heart_murmur_detection_tpu.pretrain import prepare as jprep
from heart_murmur_detection_tpu_torch.pretrain import data as pdata
from heart_murmur_detection_tpu_torch.pretrain import prepare
from heart_murmur_detection_tpu_torch.utils.audio_io import write_wav

# (seconds at 4 kHz, split, in-domain split): the 1-s clip is too short for
# the 2-s floor of the COLA path
CLIPS = [(3.0, "train", "train_pretrain"), (2.5, "val", "train_pretrain"),
         (1.0, "train", "train_pretrain"), (4.0, "test", "test"),
         (3.5, "train", "test"), (2.2, "val", "train_pretrain")]
INPUT_SEC = 2


def _feature_dir(root: str, wav_dir: str) -> str:
    """feature/circor_eval/ under root: sound_dir_loc (the shared WAVs) and
    both split files."""
    fdir = os.path.join(root, "feature", "circor_eval")
    os.makedirs(fdir)
    files = [os.path.join(wav_dir, f"{50000 + i}_AV.wav") for i in range(len(CLIPS))]
    np.save(os.path.join(fdir, "sound_dir_loc.npy"), np.array(files))
    np.save(os.path.join(fdir, "train_test_split.npy"), np.array([c[1] for c in CLIPS]))
    np.save(os.path.join(fdir, "train_test_pretrain_split.npy"), np.array([c[2] for c in CLIPS]))
    return fdir + "/"


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """(the JAX package's feature dir, the port's), over the same WAVs."""
    base = tmp_path_factory.mktemp("prep")
    wav_dir = str(base / "wav")
    os.makedirs(wav_dir)
    r = np.random.default_rng(13)
    for i, (sec, _, _) in enumerate(CLIPS):
        t = np.arange(int(sec * 4000)) / 4000
        beat = (t % 0.8) < 0.2
        x = 0.05 * r.standard_normal(len(t)) + 0.3 * beat * np.sin(2 * np.pi * 120 * t)
        write_wav(os.path.join(wav_dir, f"{50000 + i}_AV.wav"), x.astype(np.float32), 4000)
    return _feature_dir(str(base / "jax"), wav_dir), _feature_dir(str(base / "port"), wav_dir)


def _same_outputs(jdir: str, pdir: str, manifest: str):
    want = [str(n)[len(jdir):] for n in np.load(jdir + manifest)]
    got = [str(n)[len(pdir):] for n in np.load(pdir + manifest)]
    assert got == want and len(got) > 0
    for name in got:
        np.testing.assert_allclose(np.load(pdir + name + ".npy"), np.load(jdir + name + ".npy"),
                                   rtol=1e-6, atol=1e-6)
    return got


@pytest.mark.parametrize("in_domain", [False, True])
def test_preprocess_spectrogram_ssl_matches_jax(dirs, in_domain):
    jdir, pdir = dirs
    n_j = jprep.preprocess_spectrogram_ssl(jdir, input_sec=INPUT_SEC, in_domain=in_domain)
    n_p = prepare.preprocess_spectrogram_ssl(pdir, input_sec=INPUT_SEC, in_domain=in_domain)
    sel = [c for c in CLIPS if (c[2] == "train_pretrain" if in_domain else c[1] != "test")]
    assert n_p == n_j == sum(c[0] >= INPUT_SEC for c in sel)
    tag = "_in_domain" if in_domain else ""
    names = _same_outputs(jdir, pdir, f"entire_spec{tag}_filenames.npy")
    assert all(n.startswith(f"entire_spec_npy{tag}/") for n in names)
    assert np.load(pdir + names[0] + ".npy").shape[1] == 64


@pytest.mark.parametrize("in_domain", [False, True])
def test_preprocess_spectrogram_ssl_audiomae_matches_jax(dirs, in_domain):
    jdir, pdir = dirs
    n_j = jprep.preprocess_spectrogram_ssl_audiomae(jdir, in_domain=in_domain)
    n_p = prepare.preprocess_spectrogram_ssl_audiomae(pdir, in_domain=in_domain)
    assert n_p == n_j
    tag = "_in_domain" if in_domain else ""
    names = _same_outputs(jdir, pdir, f"audiomae_entire_spec{tag}_filenames.npy")
    assert np.load(pdir + names[0] + ".npy").shape[1] == 128


def test_preprocess_entire_spec_files_matches_jax(dirs, tmp_path):
    """The generic file-list form with a split array: invalid clips leave
    the manifest and the split alike."""
    jdir, _ = dirs
    files = list(np.load(jdir + "sound_dir_loc.npy"))
    split = np.array([c[1] for c in CLIPS])
    out = {}
    for tag, fn in (("jax", jprep.preprocess_entire_spec_files),
                    ("port", prepare.preprocess_entire_spec_files)):
        d = str(tmp_path / tag) + "/"
        n = fn(files, d + "spec", d + "names.npy", INPUT_SEC, split, d + "split.npy")
        out[tag] = (d, n)
    (jd, n_j), (pd, n_p) = out["jax"], out["port"]
    assert n_p == n_j == sum(c[0] >= INPUT_SEC for c in CLIPS)
    _same_outputs(jd, pd, "names.npy")
    np.testing.assert_array_equal(np.load(pd + "split.npy"), np.load(jd + "split.npy"))


def test_port_cp_reads_the_port_manifest(dirs, monkeypatch):
    """pretrain/data.py::load_corpus finds the manifests where prepare.py
    wrote them (manifest_path, from the directory holding feature/)."""
    _, pdir = dirs
    prepare.preprocess_spectrogram_ssl(pdir, input_sec=INPUT_SEC)
    prepare.preprocess_spectrogram_ssl_audiomae(pdir)
    monkeypatch.chdir(os.path.dirname(os.path.dirname(pdir.rstrip("/"))))
    cola = pdata.load_corpus("circor", 251, method="cola")
    mae = pdata.load_corpus("circor", 256, method="audiomae")
    n = sum(c[0] >= INPUT_SEC and c[1] != "test" for c in CLIPS)
    assert len(cola.train) + len(cola.val) == n
    assert all(x.ndim == 2 and x.shape[1] == 64 for x in cola.train + cola.val)
    assert len(mae.train) + len(mae.val) == sum(c[1] != "test" for c in CLIPS)
    assert all(x.shape[1] == 128 for x in mae.train + mae.val)


# ---------------------------------------------------------------------------
# the respiratory SSL preparers, on synthetic corpora in their layouts
# ---------------------------------------------------------------------------

RESP_CASES = {  # name -> (corpus dir under datasets/, function, kwargs)
    "icbhi_entire": ("icbhi", "preprocess_icbhi_entire", {}),
    "icbhi_cycles": ("icbhi", "preprocess_icbhi_cycles", {}),
    "covid19sounds_breath": ("covid19-sounds", "preprocess_covid19sounds_ssl",
                             {"modality": "breath", "input_sec": 4}),
    "covid19sounds_voice": ("covid19-sounds", "preprocess_covid19sounds_ssl",
                            {"modality": "voice", "input_sec": 4}),
    "coughvid": ("coughvid", "preprocess_coughvid_ssl", {}),
    "coviduk_cough": ("covidUK", "preprocess_coviduk_ssl", {"modality": "cough"}),
    "hflung": ("hf_lung", "preprocess_hflung_ssl", {}),
}


@pytest.fixture(scope="module")
def resp_root(tmp_path_factory):
    """The respiratory corpora that the preparers read, at their own lengths
    and 4 kHz, with the COUGHVID and COVID-UK split files (the port's split
    writers, pinned in tests/test_torch_legacy.py)."""
    from heart_murmur_detection_tpu_torch.bench.resp_corpora import write_resp_corpora
    from heart_murmur_detection_tpu_torch.data import raw_splits

    root = str(tmp_path_factory.mktemp("resp"))
    write_resp_corpora(root, seed=5, sr=4000, subjects={"icbhi": 6, "hf_lung": 6},
                       corpora=("icbhi", "covid19sounds", "coughvid", "coviduk", "hf_lung"))
    raw_splits.coughvid_build_splits(os.path.join(root, "datasets/coughvid/"), n_female_test=4,
                                     n_male_test=4, n_healthy_covid_test=1, n_covid_test=1)
    raw_splits.coviduk_build_splits(os.path.join(root, "datasets/covidUK/"))
    return root


@pytest.mark.parametrize("name", sorted(RESP_CASES))
def test_respiratory_ssl_preparer_matches_jax(name, resp_root, tmp_path, monkeypatch):
    """Each package's preparer in its own copy of the corpus (the working
    directory): the same count, every manifest and split array equal, every
    spectrogram within 1e-5."""
    import shutil

    corpus, fn, kw = RESP_CASES[name]
    counts, trees = [], []
    for tag, mod in (("jax", jprep), ("port", prepare)):
        d = tmp_path / tag
        shutil.copytree(os.path.join(resp_root, "datasets", corpus), d / "datasets" / corpus)
        monkeypatch.chdir(d)
        counts.append(getattr(mod, fn)(**kw))
        trees.append(str(d))
    assert counts[0] == counts[1] > 0
    files = [sorted(os.path.relpath(os.path.join(a, f), t) for a, _, fs in os.walk(t) for f in fs
                    if f.endswith(".npy")) for t in trees]
    assert files[0] == files[1]
    for rel in files[0]:
        want, got = (np.load(os.path.join(t, rel), allow_pickle=True) for t in trees)
        assert got.dtype == want.dtype and got.shape == want.shape, rel
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=rel)
        else:
            np.testing.assert_array_equal(got, want, err_msg=rel)
