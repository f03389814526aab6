"""The port's checkpoint re-evaluation and significance test
(train/eval_ckpts.py, cli/eval_ckpts.py, analysis/significance.py,
cli/significance.py) against the JAX package on the same features,
weights and scores: a saved probe head's metrics (1e-6), a small HTS-AT
classifier's and a full-width EfficientNet (operaCE) classifier's test
probabilities in float32 (1e-4), the cross-task name
split, a head-only CLI run on a synthetic feature dir, the t-test, and the
significance CLI's 5-seed scores."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.analysis import significance as jsig
from heart_murmur_detection_tpu.cli import eval_ckpts as jcli
from heart_murmur_detection_tpu.models.heads import Head as JHead
from heart_murmur_detection_tpu.models.htsat import HTSATConfig as JHTSATConfig
from heart_murmur_detection_tpu.train import checkpoints as jck
from heart_murmur_detection_tpu.train import eval_ckpts as jeval
from heart_murmur_detection_tpu.train import finetune as jft
from heart_murmur_detection_tpu_torch.analysis import significance as sig
from heart_murmur_detection_tpu_torch.cli import eval_ckpts as cli
from heart_murmur_detection_tpu_torch.cli import significance as cli_sig
from heart_murmur_detection_tpu_torch.extract.convert import from_jax_classifier, from_jax_head
from heart_murmur_detection_tpu_torch.models.htsat import HTSATConfig
from heart_murmur_detection_tpu_torch.train import eval_ckpts
from heart_murmur_detection_tpu_torch.train.checkpoints import save_params

# the narrow HTS-AT of tests/test_torch_finetune.py: (32, 16) inputs, 128 features
TINY_HTSAT = dict(spec_size=64, patch_size=4, embed_dim=16, depths=(1, 1, 1, 1),
                  num_heads=(2, 2, 2, 2), window_size=2, mel_bins=16, drop_path_rate=0.0)
N = 60  # clips: 24 train, 12 val, 24 test


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def feature_dir(tmp_path, monkeypatch):
    """feature/circor_eval/ in a fresh working directory: 3-class labels
    (one NaN row), the split, 64-d operaCT768 features and the (32, 16)
    first-window spectrogram cache."""
    monkeypatch.chdir(tmp_path)
    fdir = "feature/circor_eval/"
    os.makedirs(fdir)
    r = np.random.default_rng(21)
    y = np.tile(np.arange(3, dtype=np.float64), N // 3)
    y[5] = np.nan
    split = np.array((["train"] * 2 + ["val"] + ["test"] * 2) * (N // 5))
    x = r.standard_normal((N, 64)).astype(np.float32) + y[:, None].clip(0) * 0.3
    np.save(fdir + "murmurs.npy", y)
    np.save(fdir + "train_test_split.npy", split)
    np.save(fdir + "operaCT768_feature.npy", x)
    np.save(fdir + "spectrogram_pad8.npy", r.random((N, 32, 16)).astype(np.float32))
    return fdir


def _probs_of(module, monkeypatch):
    """Record the probabilities the module passes to compute_metrics."""
    seen = []
    orig = module.M.compute_metrics

    def spy(metrics, y, y_pred, probs, *a):
        seen.append(np.asarray(probs))
        return orig(metrics, y, y_pred, probs, *a)

    monkeypatch.setattr(module.M, "compute_metrics", spy)
    return seen


def _same_metrics(got, want, tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(want[k], np.float64),
                                   rtol=tol, atol=tol, err_msg=k)


def test_evaluate_linear_head_matches_jax(feature_dir):
    """A flax head saved both ways (msgpack for the JAX package, the port's
    .pt under the JAX name stem, found by prefix from cks/): the same
    metric dict to 1e-6."""
    jhead = JHead(classes=3, head="linear", feat_dim=64)
    params = jax.device_get(jhead.init(jax.random.PRNGKey(4), jnp.zeros((1, 64)))["params"])
    params = jax.tree.map(lambda a: np.asarray(a) * 40.0, params)  # past the 0.01 init scale
    jpath = jck.save_params(os.path.join("jax", "head.msgpack"), params)
    stem = "linear_operaCT768_32_0.0001_64_1e-05_0_weighted"
    save_params(f"cks/linear/circor_murmurs/{stem}-epoch=03-valid_auc=0.71.pt",
                from_jax_head(params))
    want = jeval.evaluate_linear_head(0, use_feature="operaCT768", loss="weighted",
                                      ckpt_path=jpath)
    got = eval_ckpts.evaluate_linear_head(0, use_feature="operaCT768", loss="weighted",
                                          device="cpu")
    _same_metrics(got, want, 1e-6)
    with pytest.raises(FileNotFoundError, match="No checkpoint"):
        eval_ckpts.evaluate_linear_head(1, use_feature="operaCT768", loss="weighted",
                                        device="cpu")


def test_evaluate_finetuned_model_matches_jax(feature_dir, monkeypatch):
    """A small HTS-AT classifier (a JAX init, carried over by
    from_jax_classifier and saved as the port's .pt under ckpt_name's stem):
    the same test probabilities as the JAX function's float32 graph (1e-4),
    the 24 test rows in a batch of 32 padded with repeats of its first."""
    jmodel = jft.EncoderClassifier(encoder_kind="htsat", classes=3, feat_dim=128,
                                   htsat_config=JHTSATConfig(enable_tscam=False, **TINY_HTSAT))
    v = jax.tree.map(np.asarray, jax.jit(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)},
        jnp.zeros((1, 32, 16))))())
    v = {**v, "params": {**v["params"], "head": jax.tree.map(lambda a: a * 100.0,
                                                                 v["params"]["head"])}}
    jpath = jck.save_params(os.path.join("jax", "ft.msgpack"), v)
    save_params("cks/finetune/circor_murmurs/finetuning_linear_operaCT_64_0.0001_64_0.0001_1"
                "_weighted-epoch=00-valid_auc=0.50.pt", from_jax_classifier(v, "htsat"))
    jprobs, probs = _probs_of(jeval, monkeypatch), _probs_of(eval_ckpts, monkeypatch)
    want = jeval.evaluate_finetuned_model(
        1, ckpt_path=jpath, htsat_config=JHTSATConfig(enable_tscam=False, **TINY_HTSAT))
    got = eval_ckpts.evaluate_finetuned_model(1, htsat_config=HTSATConfig(**TINY_HTSAT),
                                              device="cpu")
    assert probs[0].shape == jprobs[0].shape == (24, 3)
    np.testing.assert_allclose(probs[0], jprobs[0], atol=1e-4, rtol=1e-4)
    assert abs(got["test_auc"] - want["test_auc"]) < 1e-4
    with pytest.raises(FileNotFoundError, match="finetuning_linear_operaCE_64"):
        eval_ckpts.evaluate_finetuned_model(1, pretrain="operaCE", device="cpu")


def test_evaluate_finetuned_efficientnet_matches_jax(feature_dir, monkeypatch):
    """An operaCE classifier (the EfficientNet-B0 at full width, a JAX init
    carried over by from_jax_classifier, its running statistics calibrated
    on the cached inputs as tests/test_torch_efficientnet.py does, and back
    to flax by the JAX converter): the same float32 test probabilities as
    the JAX function (1e-4), 1280-d features into the head."""
    from heart_murmur_detection_tpu.extract.convert import convert_cola_efficientnet
    from heart_murmur_detection_tpu_torch.train.finetune import EncoderClassifier
    from tests.test_torch_efficientnet import calibrate_bn

    jmodel = jft.EncoderClassifier(encoder_kind="efficientnet", classes=3, feat_dim=1280)
    v = jax.tree.map(np.asarray, jax.jit(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(6)},
        jnp.zeros((1, 32, 16))))())
    port = EncoderClassifier("efficientnet", 3, "linear", 1280)
    port.load_state_dict(from_jax_classifier(v, "efficientnet"))
    calibrate_bn(port.encoder, torch.from_numpy(np.load(feature_dir + "spectrogram_pad8.npy")))
    enc = convert_cola_efficientnet({k: t.numpy() for k, t in port.state_dict().items()})
    v = {"params": {"encoder": enc["params"]["encoder"], "head": jax.tree.map(
        lambda a: a * 100.0, v["params"]["head"])},
         "batch_stats": {"encoder": enc["batch_stats"]["encoder"]}}
    jpath = jck.save_params(os.path.join("jax", "ce.msgpack"), v)
    save_params("cks/finetune/circor_murmurs/finetuning_linear_operaCE_64_0.0001_64_0.0001_2"
                "_weighted-epoch=00-valid_auc=0.50.pt", from_jax_classifier(v, "efficientnet"))
    jprobs, probs = _probs_of(jeval, monkeypatch), _probs_of(eval_ckpts, monkeypatch)
    want = jeval.evaluate_finetuned_model(2, pretrain="operaCE", ckpt_path=jpath)
    got = eval_ckpts.evaluate_finetuned_model(2, pretrain="operaCE", device="cpu")
    assert eval_ckpts.encoder_kind_for_eval("null") == ("efficientnet", 1280)
    assert float(probs[0].std(0).max()) > 0.05
    assert probs[0].shape == jprobs[0].shape == (24, 3)
    np.testing.assert_allclose(probs[0], jprobs[0], atol=1e-4, rtol=1e-4)
    assert abs(got["test_auc"] - want["test_auc"]) < 1e-4


@pytest.mark.parametrize("name", ["pascal_A", "zchsound_clean_murmurs", "physionet16"])
def test_split_finetuned_matches_jax(name):
    assert cli._split_finetuned(name) == jcli._split_finetuned(name)


def test_cli_eval_ckpts_head_only(feature_dir):
    """cli.eval_ckpts head_only=True over 2 seeds of heads that
    cli.linear_eval wrote: each seed's re-tested AUROC is the trained one."""
    from heart_murmur_detection_tpu_torch.cli import linear_eval

    ((s0, s1),) = linear_eval.main(["task=circor_murmurs", "pretrain=operaCT", "dim=768",
                                    "n_run=2", "device=cpu"])
    (scores,) = cli.main(["task=circor_murmurs", "pretrain=operaCT768", "head_only=True",
                          "loss=weighted", "n_run=2", "device=cpu"])
    np.testing.assert_allclose(scores, [s0, s1], rtol=0, atol=1e-6)


def test_2models_matches_jax(capsys):
    a, b = [0.71, 0.74, 0.69, 0.73, 0.72], [0.61, 0.66, 0.64, 0.60, 0.65]
    for alpha in (0.01, 1e-9):
        assert sig.test_2models(a, b, alpha) == jsig.test_2models(a, b, alpha)
    assert "Reject" in capsys.readouterr().out


# the probe's bar for a 5-seed mean, and the converged lr it is held at
# (tests/test_torch_probe.py: AUROC_SEED_BAR, LR_CONVERGED)
AUROC_SEED_BAR, LR_CONVERGED = 0.01, 1e-3


def test_cli_significance_matches_jax(tmp_path, monkeypatch):
    """cli.significance on two synthetic features of one task: each model's
    5-seed mean AUROC within the probe's bar of the JAX package's
    get_performance, from independent inits (tests/test_torch_probe.py), and
    a finite t-test of the port's scores."""
    from heart_murmur_detection_tpu.cli import significance as jcli_sig

    monkeypatch.chdir(tmp_path)
    fdir = "feature/circor_eval/"
    os.makedirs(fdir)
    r = np.random.default_rng(8)
    n = 300
    y = np.arange(n) % 3
    r.shuffle(y)
    np.save(fdir + "murmurs.npy", y.astype(np.int32))
    np.save(fdir + "train_test_split.npy", np.array(["train"] * 180 + ["val"] * 60 + ["test"] * 60))
    for name, shift in (("operaCT768", 0.3), ("clap2023", 0.15)):
        means = r.standard_normal((3, 32)) * shift
        np.save(fdir + f"{name}_feature.npy",
                (means[y] + r.standard_normal((n, 32))).astype(np.float32))
    argv = ["model1=operaCT", "dim1=768", "model2=clap2023", f"lr={LR_CONVERGED}", "device=cpu"]
    s1, s2, (t, p, _) = cli_sig.main(argv)
    cfg = {**jcli_sig.DEFAULTS, "lr": LR_CONVERGED}
    for model, got in (("operaCT", s1), ("clap2023", s2)):
        want = jcli_sig.get_performance(model, 768, cfg)
        assert len(got) == len(want) == 5 and np.isfinite(got).all()
        assert abs(np.mean(got) - np.mean(want)) < AUROC_SEED_BAR, (model, got, want)
    assert np.isfinite([t, p]).all()
    assert (t, p) == pytest.approx(sig.test_2models(s1, s2)[:2])
