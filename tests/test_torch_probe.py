"""The port's heart linear probe (CPU) against the JAX package: the metrics
copy, the heads through from_jax_head, train_linear_head from the same
initial head and batches, the 5-seed protocol and the CV function from
independent inits, on synthetic features."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.models.heads import Head as JHead
from heart_murmur_detection_tpu.train import linear_eval as jle
from heart_murmur_detection_tpu.train import metrics as JM
from heart_murmur_detection_tpu_torch.extract.convert import from_jax_head
from heart_murmur_detection_tpu_torch.models.heads import Head
from heart_murmur_detection_tpu_torch.train import linear_eval as tle
from heart_murmur_detection_tpu_torch.train import metrics as TM

AUROC_SEED_BAR = 0.01  # ROADMAP's bar for the 5-seed mean (tests/test_golden_lp.py's tolerance)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the test run shares the cores among its xdist
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _features(n_cls, n=200, d=768, shift=0.08, seed=0):
    """Class means apart by `shift` per dimension in noise of unit scale:
    separable, but not on the first epoch."""
    r = np.random.default_rng(seed)
    y = np.arange(n) % n_cls
    r.shuffle(y)
    means = r.standard_normal((n_cls, d)) * shift
    x = (means[y] + r.standard_normal((n, d))).astype(np.float32)
    return x, y.astype(np.int32)


@pytest.mark.parametrize("n_cls", [2, 3, 4])
def test_metrics_copy_matches_original(n_cls):
    r = np.random.default_rng(n_cls)
    y = r.integers(0, n_cls, 97)
    probs = r.dirichlet(np.ones(n_cls), 97)
    pred = probs.argmax(1)
    ann = r.integers(0, 2, 97)
    # the clinical scores take their task's classes: outcomes and physionet16
    # two, murmurs three; four classes run the standard metrics alone
    tasks = {2: (("circor", "outcomes"), ("physionet16", ""), ("circor", "murmurs")),
             3: (("circor", "murmurs"),), 4: ((None, None),)}[n_cls]
    for ds, task in tasks:
        want = JM.compute_metrics(jle.HEART_METRICS, y, pred, probs, n_cls, ds, task, ann)
        got = TM.compute_metrics(tle.HEART_METRICS, y, pred, probs, n_cls, ds, task, ann)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-7, err_msg=k)
        assert TM.expand_per_class(got, ds, task) == JM.expand_per_class(want, ds, task)
    assert TM.auroc(y, probs, n_cls, "weighted") == JM.auroc(y, probs, n_cls, "weighted")


@pytest.mark.parametrize("head", ["linear", "mlp"])
def test_head_from_jax(head):
    x = np.random.default_rng(0).standard_normal((5, 64)).astype(np.float32)
    jh = JHead(classes=3, head=head, feat_dim=64)
    params = jh.init(jax.random.PRNGKey(0), jnp.zeros((1, 64)))["params"]
    want = np.asarray(jh.apply({"params": params}, x))
    th = Head(3, head, 64)
    th.load_state_dict(from_jax_head(jax.tree.map(np.asarray, params)))
    got = th(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # the port's own init: N(0, 0.01) weights, zero biases
    own = dict(Head(3, head, 512, generator=torch.Generator().manual_seed(0)).named_parameters())
    w = torch.cat([p.detach().flatten() for n, p in own.items() if n.endswith("weight")])
    assert abs(float(w.std()) - 0.01) < 1e-3
    assert all(float(p.detach().abs().max()) == 0 for n, p in own.items() if n.endswith("bias"))


def _split(x, y):
    n = len(x)
    a, b = int(0.6 * n), int(0.8 * n)
    return x[:a], y[:a], x[a:b], y[a:b], x[b:], y[b:]


@pytest.mark.parametrize("n_cls,weighted,head", [
    (2, False, "linear"), (3, False, "linear"), (3, True, "linear"), (2, True, "mlp"),
])
def test_train_linear_head_matches_jax_from_same_init(n_cls, weighted, head, monkeypatch):
    """The same initial head (the JAX init carried across) and the same
    batches: the best epoch equal, the best head's test probabilities
    within 1e-4, the test AUROC within 1e-3."""
    x, y = _features(n_cls)
    xtr, ytr, xva, yva, xte, yte = _split(x, y)
    cw = jle.get_class_weights(ytr, n_cls) if weighted else None
    np.testing.assert_array_equal(tle.get_class_weights(ytr, n_cls), jle.get_class_weights(ytr, n_cls))
    epochs = 64 if head == "linear" else 16
    kw = dict(n_cls=n_cls, head=head, epochs=epochs, class_weights=cw, seed=3, lr=1e-4)
    jres = jle.train_linear_head(xtr, ytr, xva, yva, xte, yte, **kw)
    init = JHead(classes=n_cls, head=head, feat_dim=x.shape[1]).init(
        jax.random.PRNGKey(3), jnp.zeros((1, x.shape[1])))["params"]

    def jax_init_head(*args, **kwargs):
        h = Head(*args, **kwargs)
        h.load_state_dict(from_jax_head(jax.tree.map(np.asarray, init)))
        return h

    monkeypatch.setattr(tle, "Head", jax_init_head)
    tres = tle.train_linear_head(xtr, ytr, xva, yva, xte, yte, device="cpu", **kw)
    assert tres.best_epoch == jres.best_epoch
    jprobs = np.asarray(jax.nn.softmax(JHead(classes=n_cls, head=head, feat_dim=x.shape[1]).apply(
        {"params": jres.params}, xte), axis=-1))
    th = Head(n_cls, head, x.shape[1])
    th.load_state_dict(tres.params)
    tprobs = torch.softmax(th(torch.from_numpy(xte)), -1).detach().numpy()
    np.testing.assert_allclose(tprobs, jprobs, atol=1e-4)
    assert abs(tres.test_auc - jres.test_auc) < 1e-3
    assert abs(tres.valid_auc - jres.valid_auc) < 1e-3


def test_make_perms_copy():
    a = tle._make_perms(np.random.default_rng(7), 70, 32, 3)
    b = jle._make_perms(np.random.default_rng(7), 70, 32, 3)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (3, 3, 32) and (a[:, -1, 6:] == -1).all()


# Independent inits need a probe that converges: at the grid's lr 1e-3, 64
# epochs of 240 clips do; at 1e-4 the probe has moved its weights about as
# far as the N(0, 0.01) init spreads them, and both packages' 5-seed means
# then wander by +-0.03 with the seeds, above the bar.
LR_CONVERGED = 1e-3


@pytest.fixture(scope="module")
def feature_dir(tmp_path_factory):
    """A CirCor-like feature dir: 3 murmur classes, train / val / test."""
    d = str(tmp_path_factory.mktemp("feat")) + "/"
    x, y = _features(3, n=400, d=128, shift=0.15, seed=0)
    split = np.array(["train"] * 240 + ["val"] * 80 + ["test"] * 80)
    np.save(d + "operaCT768_feature.npy", x)
    np.save(d + "murmurs.npy", y)
    np.save(d + "train_test_split.npy", split)
    return d


def test_five_seed_mean_matches_jax(feature_dir, tmp_path):
    """Independent inits (the JAX PRNG vs a torch generator), the same
    batches: the 5-seed mean test AUROC within ROADMAP's bar; the port
    writes each seed's best head as a state_dict under the JAX name stem."""
    kw = dict(use_feature="operaCT768", loss="weighted", dataset_name="circor", task="murmurs",
              feature_dir=feature_dir, labels_filename="murmurs.npy", lr=LR_CONVERGED)
    _, jmean, _ = jle.run_seeds(jle.linear_evaluation_heart, 5, **kw)
    ck = str(tmp_path / "cks")
    tscores, tmean, tstd = tle.run_seeds(tle.linear_evaluation_heart, 5, device="cpu",
                                         save_ckpt_dir=ck, **kw)
    assert np.isfinite(tscores).all() and tstd >= 0
    assert abs(tmean - jmean) < AUROC_SEED_BAR, (tmean, jmean)
    saved = sorted(os.listdir(ck))
    assert len(saved) == 5 and all(f.startswith("linear_operaCT768_32_0.001_64_1e-05_")
                                   and "_weighted-epoch=" in f and f.endswith(".pt")
                                   for f in saved)
    sd = torch.load(os.path.join(ck, saved[0]))
    assert set(sd) == {"fc.weight", "fc.bias"} and sd["fc.weight"].shape == (3, 128)
    assert sd["fc.weight"].device.type == "cpu"


def test_cv_matches_jax(feature_dir):
    """linear_evaluation_heart_cv: the numpy StratifiedKFold gives the JAX
    package's folds; from independent inits, the mean fold AUROC agrees
    within the same bar."""
    kw = dict(use_feature="operaCT768", feature_dir=feature_dir, labels_filename="murmurs.npy",
              loss="weighted", epochs=32, lr=LR_CONVERGED)
    j = jle.linear_evaluation_heart_cv(seed=1, **kw)
    t = tle.linear_evaluation_heart_cv(seed=1, device="cpu", **kw)
    assert len(t) == len(j) == 5 and np.isfinite(t).all()
    assert abs(np.mean(t) - np.mean(j)) < AUROC_SEED_BAR, (t, j)


def test_probe_wants_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x, y = _features(2, n=20, d=8)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tle.train_linear_head(x, y, x, y, n_cls=2, epochs=1)
