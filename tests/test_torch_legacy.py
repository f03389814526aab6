"""The port's legacy OPERA respiratory benchmark against the JAX package on
the CPU: the metadata reader (utils/table.py) against pandas, the scaler
against sklearn, the balanced downsampler, every saved array of the ten
processors and the three raw-split writers on synthetic corpora
(bench/resp_corpora.py) bit for bit, the ICBHI annotation / cycle
functions, the regression probe and the legacy task functions from the JAX
package's initial heads, the two LOOCV task functions, the CLI's legacy and LOOCV
branches, and that the port never imports pandas or sklearn."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from heart_murmur_detection_tpu.audio import icbhi as jicbhi
from heart_murmur_detection_tpu.audio import pipelines as jpipe
from heart_murmur_detection_tpu.data import raw_splits as jraw
from heart_murmur_detection_tpu.data.processors import respiratory as jresp
from heart_murmur_detection_tpu.models.heads import Head as JHead
from heart_murmur_detection_tpu.train import legacy_tasks as jlt
from heart_murmur_detection_tpu.train import linear_eval as jle
from heart_murmur_detection_tpu.utils import balance as jbal
from heart_murmur_detection_tpu_torch.audio import icbhi
from heart_murmur_detection_tpu_torch.audio import pipelines
from heart_murmur_detection_tpu_torch.cli import linear_eval as cli_le
from heart_murmur_detection_tpu_torch.data import raw_splits
from heart_murmur_detection_tpu_torch.data.processors import respiratory as resp
from heart_murmur_detection_tpu_torch.data.splits import standard_scale
from heart_murmur_detection_tpu_torch.extract.convert import from_jax_head
from heart_murmur_detection_tpu_torch.models.heads import Head
from heart_murmur_detection_tpu_torch.train import legacy_tasks as lt
from heart_murmur_detection_tpu_torch.train import linear_eval as tle
from heart_murmur_detection_tpu_torch.utils import balance, table

from heart_murmur_detection_tpu_torch.bench.resp_corpora import write_resp_corpora, write_xlsx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5  # the regression probe and the LOOCV task functions, the same init
AUROC_TOL = 1e-3  # a classification task's test AUROC (tests/test_torch_probe.py's bar)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_port_imports_no_pandas_or_sklearn():
    """Every module of the port imported in a fresh interpreter: neither
    pandas, sklearn nor jax in sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import heart_murmur_detection_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(sorted({k.split('.')[0] for k in sys.modules} & {'pandas', 'sklearn', 'jax'}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# the metadata reader against pandas, the scaler against sklearn
# ---------------------------------------------------------------------------

TRICKY_CSV = (
    "id,ints,gap,flt,boolean,boolna,mixed,nas,digits,allna\n"
    "a1,1,1,1.5,True,True,y,NA,007,\n"
    "a2,-2,,3e2,False,,True,null,8,\n"
    "\n"
    'a3,+3,4,inf,TRUE,False,"q, r",x,9,\n'
    "a4, 5 ,7,.5,false,True,n,N/A,10,\n"
)


def _py(v):
    """A pandas cell as a plain Python value (numpy scalars unwrapped)."""
    return v.item() if isinstance(v, np.generic) else v


def _same_cell(a, b) -> bool:
    if table.is_na(a) or table.is_na(b):
        return table.is_na(a) and table.is_na(b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("as_str", [False, True])
def test_read_csv_types_like_pandas(tmp_path, as_str):
    p = tmp_path / "t.csv"
    p.write_text(TRICKY_CSV)
    want = pd.read_csv(p, dtype=str if as_str else None)
    got = table.read_csv(str(p), as_str=as_str)
    assert list(got.columns) == list(want.columns)
    for c in want.columns:
        w = [_py(v) for v in want[c].tolist()]
        assert all(_same_cell(a, b) for a, b in zip(got[c], w)), (c, got[c], w)
    # iterrows with an index column; a frame of int and float columns upcasts
    for (k, row), (kw, roww) in zip(got.iterrows("id"), want.set_index("id").iterrows()):
        assert k == kw and all(_same_cell(row[c], _py(roww[c])) for c in roww.index)
    q = tmp_path / "n.csv"
    q.write_text("a,b\n1,2.5\n3,4\n")
    rows = [r for _, r in table.read_csv(str(q)).iterrows()]
    assert rows == [{k: _py(v) for k, v in r.items()} for _, r in pd.read_csv(q).iterrows()]
    assert all(type(v) is float for r in rows for v in r.values())


def test_lookup_and_merge_like_pandas(tmp_path):
    p = tmp_path / "d.txt"
    p.write_text("101\tCOPD\n102\t\n103\tURTI\n103\tLRTI\n")
    want = pd.read_csv(p, sep="\t", names=["k", "v"], dtype=str).set_index("k")["v"]
    got = table.read_csv(str(p), sep="\t", names=["k", "v"], as_str=True).lookup("k", "v")
    assert got.loc("101") == want.loc["101"]
    assert table.is_na(got.loc("102")) and table.is_na(want.loc["102"])
    assert list(got.loc("103")) == list(want.loc["103"])
    with pytest.raises(KeyError):
        got.loc("104")
    a, b = tmp_path / "a.csv", tmp_path / "b.csv"
    a.write_text("k,x\np2,1\np1,2\np2,3\np9,4\n")
    b.write_text("k,s\np1,train\np2,val\np2,test\n")
    want = pd.merge(pd.read_csv(a), pd.read_csv(b), on="k")
    got = table.merge_inner(table.read_csv(str(a)), table.read_csv(str(b)), "k")
    for c in want.columns:
        assert got[c] == [_py(v) for v in want[c].tolist()]


def test_read_excel_matches_the_table_written(tmp_path):
    header = ["name", "n", "x", "gap", "flag"]
    rows = [["a", 1, 0.5, 2.5, True], ["b", 2, 1.0, None, False], ["c", 3, 7.25, 1.0, True]]
    write_xlsx(str(tmp_path / "t.xlsx"), header, rows)
    got = table.read_excel(str(tmp_path / "t.xlsx"))
    assert got.kinds == {"name": "str", "n": "int", "x": "float", "gap": "float", "flag": "bool"}
    assert got["n"] == [1, 2, 3] and got["x"] == [0.5, 1.0, 7.25]
    assert got["gap"][0] == 2.5 and table.is_na(got["gap"][1])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_standard_scale_matches_sklearn(dtype):
    from sklearn.preprocessing import StandardScaler

    r = np.random.default_rng(3)
    x = (r.standard_normal((39, 30)) * r.uniform(0.1, 50, 30) + r.uniform(-1e3, 1e3, 30))
    x = x.astype(dtype)
    x[:, 2], x[:, 5] = 7.25, 0.0  # constant columns: scale 1
    t = r.standard_normal((2, 30)).astype(dtype)
    sc = StandardScaler()
    want = (sc.fit_transform(x), sc.transform(t))
    got = standard_scale(x, t)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [None, 4])
def test_downsample_balanced_matches_jax(seed):
    r = np.random.default_rng(0)
    x = r.standard_normal((50, 6))
    y = np.array([0] * 30 + [1] * 12 + [2] * 8)
    np.random.seed(11)
    want = jbal.downsample_balanced_dataset(x, y, seed=seed)
    np.random.seed(11)
    got = balance.downsample_balanced_dataset(x, y, seed=seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert np.bincount(got[1]).tolist() == [8, 8, 8]


# ---------------------------------------------------------------------------
# processors and raw splits: every saved array, bit for bit
# ---------------------------------------------------------------------------


# every corpus at 4 kHz, each recording a few hundredths of a second (the
# processors only list files); 5 NoseMic subjects and 12 MMLung participants
# keep the LOOCV folds few
SMALL = dict(seed=5, sr=4000, sec=0.05, subjects={"nosemic": 5, "mmlung": 12})


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """(root, MMLung's table, recordings written per corpus)."""
    root = tmp_path_factory.mktemp("corpora")
    written, table_ = write_resp_corpora(str(root), **SMALL)
    return str(root), table_, written


def _saved(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith((".npy", ".csv")):
                out[os.path.relpath(os.path.join(d, f), root)] = os.path.join(d, f)
    return out


def _same_array(a: np.ndarray, b: np.ndarray) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.kind == "f":
        return np.array_equal(a, b, equal_nan=True)
    if a.dtype.kind == "O":
        return all(_same_cell(x, y) for x, y in zip(a.ravel().tolist(), b.ravel().tolist()))
    return np.array_equal(a, b)


def _run_both(corpora, tmp_path, monkeypatch, jax_fn, port_fn):
    """Each package's function in its own copy of the corpora (as the working
    directory); returns both returns and every .npy / .csv the two wrote,
    which must be the same files holding equal arrays (dtype included)."""
    root = corpora[0]
    rets = []
    for tag, fn in (("jax", jax_fn), ("port", port_fn)):
        d = str(tmp_path / tag)
        shutil.copytree(root, d)
        monkeypatch.chdir(d)
        rets.append(fn())
    before = _saved(root)
    jax_out, port_out = _saved(str(tmp_path / "jax")), _saved(str(tmp_path / "port"))
    assert jax_out.keys() == port_out.keys()
    new = sorted(set(jax_out) - set(before))
    for rel in new:
        if rel.endswith(".csv"):
            assert open(jax_out[rel]).read() == open(port_out[rel]).read(), rel
            continue
        a = np.load(jax_out[rel], allow_pickle=True)
        b = np.load(port_out[rel], allow_pickle=True)
        assert _same_array(b, a), (rel, b, a)
    return rets, new


def _mmlung_frame(table_):
    return pd.DataFrame({k: [np.nan if v is None else v for v in vals]
                         for k, vals in table_.items()})


def _seq(mod, *calls):
    """Call mod.<name>(**kw) for each (name, kw) in order; the returns."""
    return lambda: [getattr(mod, name)(**kw) for name, kw in calls]


COUGHVID_SPLIT = dict(n_female_test=4, n_male_test=4, n_healthy_covid_test=1, n_covid_test=1)
PROCESSORS = {
    "copd": [("copd_preprocess_split", {})],
    "kauh": [("kauh_preprocess", {})],
    "icbhidisease": [("icbhi_process_disease", {})],
    "snoring": [("ssbpr_preprocess", {})],
    "nosemic": [("nosemic_process_label", {})],
    "mmlung": [("mmlung_process_label", {}), ("mmlung_sound_dirs", {})],
    "coswara": [("coswara_preprocess_label", {"label": "sex"}),
                ("coswara_preprocess_label", {"label": "smoker"})],
    "covid19sounds": [("covid19sounds_preprocess_task1", {"modality": "cough"}),
                      ("covid19sounds_preprocess_task1", {"modality": "breath"}),
                      ("covid19sounds_task1_downsample", {})],
}
RAW_THEN_PROCESS = {
    "coughvid": ([("coughvid_build_splits", {"data_dir": "datasets/coughvid/", **COUGHVID_SPLIT})],
                 [("coughvid_preprocess_label", {"label": "covid"}),
                  ("coughvid_preprocess_label", {"label": "gender"})]),
    "coviduk": ([("coviduk_build_splits", {"data_dir": "datasets/covidUK/"})],
                [("coviduk_process_label", {"modality": "exhalation"}),
                 ("coviduk_process_label", {"modality": "cough"})]),
    "hflung": ([("hflung_build_metadata", {})], []),
}


@pytest.mark.parametrize("name", sorted(PROCESSORS))
def test_processor_matches_jax(name, corpora, tmp_path, monkeypatch):
    monkeypatch.setattr(pd, "read_excel", lambda path: _mmlung_frame(corpora[1]))
    (want, got), new = _run_both(corpora, tmp_path, monkeypatch,
                                 _seq(jresp, *PROCESSORS[name]), _seq(resp, *PROCESSORS[name]))
    assert got == want and new


@pytest.mark.parametrize("name", sorted(RAW_THEN_PROCESS))
def test_raw_splits_then_processor_match_jax(name, corpora, tmp_path, monkeypatch):
    raw, proc = RAW_THEN_PROCESS[name]
    (want, got), new = _run_both(
        corpora, tmp_path, monkeypatch,
        lambda: _seq(jraw, *raw)() + _seq(jresp, *proc)(),
        lambda: _seq(raw_splits, *raw)() + _seq(resp, *proc)())
    assert got == want and new


def test_processor_counts(corpora, tmp_path, monkeypatch):
    """The synthetic metadata reaches the cases it was written for."""
    root, _, written = corpora
    monkeypatch.chdir(root)
    d = str(tmp_path) + "/"
    resp.icbhi_process_disease(feature_dir=d + "icbhi/")
    labels = np.load(d + "icbhi/labels.npy")
    assert "nan" in labels.tolist() and len(labels) == written["icbhi"] == 60
    resp.kauh_preprocess(feature_dir=d + "kauh/")
    assert len(np.load(d + "kauh/labels_both.npy")) == 48
    resp.ssbpr_preprocess(feature_dir=d + "ssbpr/")
    assert 5 not in np.load(d + "ssbpr/labels.npy").tolist()
    resp.coswara_preprocess_label("smoker", feature_dir=d + "cw/")
    assert len(np.load(d + "cw/smoker_label_breathing-deep.npy")) > 0


def test_repeated_key_raises_like_jax(corpora, tmp_path, monkeypatch):
    """A diagnosis file listing a read patient twice: pandas' .loc gives a
    Series and np.save of the ragged labels raises; so does the port."""
    root = corpora[0]
    errs = []
    for fn in (jresp.icbhi_process_disease, resp.icbhi_process_disease):
        d = tmp_path / fn.__module__.split(".")[0]
        shutil.copytree(root, d)
        with open(d / "datasets/icbhi/ICBHI_Challenge_diagnosis.txt", "a") as f:
            f.write("103\tAsthma\n")
        monkeypatch.chdir(d)
        with pytest.raises(ValueError) as e:
            fn()
        errs.append(e.type)
    assert errs[0] is errs[1]


# ---------------------------------------------------------------------------
# ICBHI cycles and the whole-clip pipeline's yt= entry
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def icbhi_audio(tmp_path_factory):
    root = tmp_path_factory.mktemp("icbhi_audio")
    write_resp_corpora(str(root), corpora=("icbhi",), subjects={"icbhi": 4})
    return str(root / "datasets" / "icbhi") + "/"


@pytest.mark.parametrize("class_split", ["cycle", "diagnosis"])
def test_icbhi_annotations_match_jax(icbhi_audio, class_split):
    folder = icbhi_audio + "ICBHI_final_database/"
    diag = icbhi_audio + "ICBHI_Challenge_diagnosis.txt"
    want = jicbhi.get_annotations(class_split, folder, diag)
    got = icbhi.get_annotations(class_split, folder, diag)
    assert got.keys() == want.keys()
    for k in want:
        assert len(got[k]) == len(want[k])
        for g, w in zip(got[k], want[k]):
            assert all(_same_cell(a, _py(b)) for a, b in zip(g, w))


@pytest.mark.parametrize("class_split,n_cls", [("cycle", 4), ("cycle", 2), ("diagnosis", 3),
                                               ("diagnosis", 2)])
def test_icbhi_cycles_match_jax(icbhi_audio, class_split, n_cls):
    folder = icbhi_audio + "ICBHI_final_database/"
    diag = icbhi_audio + "ICBHI_Challenge_diagnosis.txt"
    ann = jicbhi.get_annotations(class_split, folder, diag)
    name = "103_1b1_Al_sc_Meditron"
    want = jicbhi.get_individual_cycles(class_split, ann[name], folder, name, 16000, n_cls)
    got = icbhi.get_individual_cycles(class_split, ann[name], folder, name, 16000, n_cls)
    assert [c[1] for c in got] == [c[1] for c in want] and len(got) > 1
    for (g, _), (w, _) in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw", [dict(spectrogram=True), dict(pad=True, max_sec=2.2)])
def test_get_entire_signal_yt_matches_jax(icbhi_audio, kw):
    """The waveform given as `yt` (the ICBHI cycles' entry) and read from
    its file: the JAX function's output both ways."""
    path = icbhi_audio + "ICBHI_final_database/101_1b1_Al_sc_Meditron.wav"
    want = jpipe.get_entire_signal(path, input_sec=2, **kw)
    np.testing.assert_allclose(pipelines.get_entire_signal(path, input_sec=2, **kw), want,
                               atol=1e-5)
    y = np.random.default_rng(1).standard_normal(40000).astype(np.float32)
    np.testing.assert_allclose(pipelines.get_entire_signal("", input_sec=2, yt=y, **kw),
                               jpipe.get_entire_signal("", input_sec=2, yt=y, **kw), atol=1e-5)


# ---------------------------------------------------------------------------
# the regression probe, the task functions, the CLI (from the JAX initial heads)
# ---------------------------------------------------------------------------


def _jax_rhead_init(head: str, feat_dim: int, seed: int) -> dict:
    """The initial params of the JAX train_regression_head's RHead: the same
    flax module structure initialised from PRNGKey(seed)."""
    import flax.linen as nn

    class RHead(nn.Module):
        @nn.compact
        def __call__(self, x):
            init = nn.initializers.normal(0.01)
            if head == "linear":
                return nn.Dense(1, kernel_init=init)(x)
            h = nn.relu(nn.Dense(feat_dim, kernel_init=init)(x))
            return nn.Dense(1, kernel_init=init)(h)

    p = RHead().init(jax.random.PRNGKey(seed), jnp.zeros((1, feat_dim)))["params"]
    p = jax.tree.map(np.asarray, p)
    names = ["fc"] if head == "linear" else ["fc1", "fc2"]
    return {n: p[f"Dense_{i}"] for i, n in enumerate(names)}


@pytest.fixture()
def jax_inits(monkeypatch):
    """The port's Head built with the JAX package's initial params: the
    classification Head of train_linear_head (flax Head, PRNGKey(seed)) and
    the regression head of train_regression_head (RHead, PRNGKey(seed)),
    the seed taken from the generator the port passes."""

    def head(classes, kind="linear", feat_dim=768, generator=None):
        seed = generator.initial_seed()
        h = Head(classes, kind, feat_dim)
        if classes == 1:
            params = _jax_rhead_init(kind, feat_dim, seed)
        else:
            params = jax.tree.map(np.asarray, JHead(classes=classes, head=kind, feat_dim=feat_dim)
                                  .init(jax.random.PRNGKey(seed), jnp.zeros((1, feat_dim)))["params"])
        h.load_state_dict(from_jax_head(params))
        return h

    monkeypatch.setattr(tle, "Head", head)


def _regression_data(n=90, d=24, seed=0):
    r = np.random.default_rng(seed)
    w = r.standard_normal(d)
    x = r.standard_normal((n, d)).astype(np.float32)
    y = (x @ w * 0.3 + 15 + 0.2 * r.standard_normal(n)).reshape(-1, 1)
    return x, y


@pytest.mark.parametrize("head,patience,lr", [("mlp", None, 1e-3), ("linear", 5, 1e-1)])
def test_train_regression_head_matches_jax(jax_inits, head, patience, lr):
    x, y = _regression_data()
    args = (x[:60], y[:60], x[60:75], y[60:75], x[75:], y[75:])
    kw = dict(head=head, lr=lr, l2_strength=1e-1, epochs=20, batch_size=16, patience=patience,
              seed=2)
    want = jle.train_regression_head(*args, **kw)
    got = tle.train_regression_head(*args, device="cpu", **kw)
    np.testing.assert_allclose(got, want, rtol=REL)


def _write_features(root: str, rng_seed: int = 0, d: int = 16):
    """Feature files beside each processor's outputs, the label's class
    mean apart so the probes learn."""
    r = np.random.default_rng(rng_seed)

    def feat(labels, shift=0.6):
        labels = np.asarray([hash(str(v)) % 97 for v in labels])
        means = {v: r.standard_normal(d) * shift for v in set(labels.tolist())}
        return np.stack([means[v] + r.standard_normal(d) for v in labels]).astype(np.float32)

    f = lambda *p: os.path.join(root, "feature", *p)
    np.save(f("copd_eval", "operaCT768_feature.npy"), feat(np.load(f("copd_eval", "labels.npy"))))
    np.save(f("icbhidisease_eval", "opensmile_feature.npy"),
            feat(np.load(f("icbhidisease_eval", "labels.npy"))))
    np.save(f("kauh_eval", "vggish_feature_both.npy"), feat(np.load(f("kauh_eval", "labels_both.npy"))))
    np.save(f("snoring_eval", "operaCT768_feature.npy"), feat(np.load(f("snoring_eval", "labels.npy"))))
    for lab in ("covid", "gender"):
        np.save(f("coughvid_eval", f"vggish_feature_{lab}.npy"),
                feat(np.load(f("coughvid_eval", f"label_{lab}.npy"))))
    np.save(f("coviduk_eval", "operaCT768_feature_exhalation.npy"),
            feat(np.load(f("coviduk_eval", "label_exhalation.npy"))))
    lab = np.load(f("covid19sounds_eval", "downsampled", "labels.npy"))
    np.save(f("covid19sounds_eval", "downsampled", "operaCT768_feature_cough.npy"), feat(lab))
    # coswara's aligned labels: 40 clips (the task function splits them twice)
    y = np.arange(40) % 2
    np.save(f("coswara_eval", "breathing_aligned_smoker_label_breathing-deep.npy"), y)
    np.save(f("coswara_eval", "vggish_feature_breathing-deep_smoker.npy"), feat(y))
    np.save(f("coswara_eval", "operaCT768_feature_breathing-deep_smoker.npy"), feat(y))
    y = np.load(f("nosemic_eval", "labels.npy")).astype(float)
    np.save(f("nosemic_eval", "operaCT768_feature.npy"), feat(np.round(y)))
    np.save(f("nosemic_eval", "opensmile_feature.npy"), feat(np.round(y)) * 50 + 3)
    lab = np.load(f("mmlung_eval", "label.npy"))
    for pre in ("Deep_Breath_file_", "O_Single_file_"):
        np.save(f("mmlung_eval", pre + "opensmile_feature.npy"), feat(np.round(lab[:, 0])) * 20)
        np.save(f("mmlung_eval", pre + "operaCT768_feature.npy"), feat(np.round(lab[:, 1])))


@pytest.fixture(scope="module")
def feature_root(tmp_path_factory):
    """The corpora processed by the port, with synthetic feature files."""
    root = tmp_path_factory.mktemp("features")
    write_resp_corpora(str(root), **SMALL)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        resp.copd_preprocess_split()
        resp.icbhi_process_disease()
        resp.kauh_preprocess()
        resp.ssbpr_preprocess()
        resp.nosemic_process_label()
        resp.mmlung_process_label()
        raw_splits.coughvid_build_splits("datasets/coughvid/", **COUGHVID_SPLIT)
        raw_splits.coviduk_build_splits("datasets/covidUK/")
        for lab in ("covid", "gender"):
            resp.coughvid_preprocess_label(lab)
        resp.coviduk_process_label("exhalation")
        resp.covid19sounds_preprocess_task1("cough")
        resp.covid19sounds_task1_downsample()
        os.makedirs("feature/coswara_eval", exist_ok=True)
        _write_features(str(root))
    finally:
        os.chdir(cwd)
    return str(root)


TASK_FNS = {  # name -> kwargs (epochs cut for time; the splits are the function's own)
    "copd": dict(use_feature="operaCT768"),
    "icbhidisease": dict(use_feature="opensmile"),
    "kauh": dict(use_feature="vggish"),
    "ssbpr": dict(use_feature="operaCT768"),
    "coughvid": dict(use_feature="vggish", label="gender"),
    "coviduk": dict(use_feature="operaCT768"),
    "covid19sounds": dict(use_feature="operaCT768"),
    "coswara": dict(use_feature="vggish"),
}


@pytest.mark.parametrize("name", sorted(TASK_FNS))
def test_legacy_task_matches_jax(name, feature_root, jax_inits, monkeypatch):
    monkeypatch.chdir(feature_root)
    kw = dict(TASK_FNS[name], epochs=8, seed=1, head="linear", lr=1e-3)
    if name == "ssbpr":
        kw["n_cls"] = len(set(np.load("feature/snoring_eval/labels.npy").tolist()))
    fn = f"linear_evaluation_{name}"
    np.random.seed(0)
    want = getattr(jlt, fn)(**kw)
    np.random.seed(0)
    got = getattr(lt, fn)(device="cpu", **kw)
    assert np.isfinite(got) and abs(got - want) <= AUROC_TOL, (got, want)


@pytest.mark.parametrize("name,feature", [("mmlung", "opensmile"), ("mmlung", "operaCT768"),
                                          ("nosemic", "operaCT768"), ("nosemic", "opensmile")])
def test_loocv_task_matches_jax(name, feature, feature_root, jax_inits, monkeypatch):
    """The same folds, each fold's MAE and MAPE within 1e-5 relative. A
    MMLung fold holds out one recording, so its MAE is |pt - yt| of a single
    prediction: where pt lands near yt one float32 ulp of pt is more than
    1e-5 of the MAE, so the bar is 1e-5 of the larger of the MAE and the
    targets' mean magnitude (of 1 for the MAPE, a ratio to the target)."""
    monkeypatch.chdir(feature_root)
    kw = dict(use_feature=feature, epochs=6, head="mlp")
    if name == "mmlung":
        kw.update(label="FEV1", modality="breath", batch_size=8)
        y_scale = np.abs(np.load("feature/mmlung_eval/label.npy")[:, 1]).mean()
    else:
        y_scale = np.abs(np.load("feature/nosemic_eval/labels.npy").astype(float)).mean()
    fn = f"linear_evaluation_{name}"
    want = getattr(jlt, fn)(**kw)
    got = getattr(lt, fn)(device="cpu", **kw)
    n_folds = 12 if name == "mmlung" else 5
    assert len(got[0]) == len(want[0]) == n_folds
    np.testing.assert_allclose(got[0], want[0], rtol=REL, atol=REL * y_scale)
    np.testing.assert_allclose(got[1], want[1], rtol=REL, atol=REL)


@pytest.mark.parametrize("argv,n", [
    (["task=copd", "pretrain=operaCT", "dim=768", "n_run=2", "lr=1e-3"], 2),
    (["LOOCV=True", "task=rr", "head=mlp", "pretrain=operaCT", "dim=768"], 5),
    (["LOOCV=True", "task=spirometry", "label=FVC", "modality=breath", "head=linear",
      "pretrain=opensmile"], 12),
])
def test_cli_legacy_and_loocv_on_cpu(argv, n, feature_root, monkeypatch, capsys):
    """The CLI's branches with device=cpu: the JAX CLI's lines, the scores
    of the task functions called directly."""
    monkeypatch.chdir(feature_root)
    (res,) = cli_le.main(argv + ["device=cpu"])
    out = capsys.readouterr().out
    if "LOOCV=True" in argv:
        maes, mapes = res
        assert len(maes) == len(mapes) == n and np.isfinite(maes).all()
        assert f"MAE mean {np.mean(maes):.3f} ± {np.std(maes):.3f}" in out
        assert f"MAPE mean {np.mean(mapes):.3f}" in out
    else:
        assert len(res) == n and np.isfinite(res).all()
        assert res[1] == lt.linear_evaluation_copd(use_feature="operaCT768", lr=1e-3,
                                                   l2_strength=1e-5, seed=1, device="cpu")
        assert f"Five times mean task copd feature operaCT768 results: auc mean {np.mean(res):.3f}" in out
