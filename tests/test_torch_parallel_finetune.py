"""Data-parallel fine-tuning on gloo ranks spawned on the CPU
(train/finetune.py::finetune_classifier with a parallel/mesh.py mesh): the
HTS-AT at world 2 against the JAX finetune_classifier on a 2-device mesh
(tests/test_parallel.py:519's oracle) and against the port's one-device
run; the weighted loss over an uneven class mix with a padded last batch;
ZeRO-3 (the oracle at tests/test_parallel.py:557, fsdp); a batch the ranks
cannot split refused before any rank trains. Strict float32, DropPath off
(each rank draws its own). Every world-2 run shares one launch; the
single-device and JAX runs run in this process meanwhile."""

import concurrent.futures

import numpy as np
import pytest
import torch

import heart_murmur_detection_tpu.train.finetune as jft
from heart_murmur_detection_tpu.models.htsat import HTSATConfig as JHTSATConfig
from heart_murmur_detection_tpu.parallel.mesh import data_parallel_mesh
from heart_murmur_detection_tpu_torch.extract.convert import from_jax_classifier
from heart_murmur_detection_tpu_torch.models.htsat import HTSATConfig
from heart_murmur_detection_tpu_torch.parallel import launch
from heart_murmur_detection_tpu_torch.train import finetune as ft
from tests import torch_parallel_ranks as R
from tests.test_torch_finetune import TINY_HTSAT, _clf_data, _jax_init


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads in the test process (the ranks take one each):
    the test run shares the cores among its xdist workers (see
    test_torch_swin.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TRAINER = "heart_murmur_detection_tpu_torch.train.finetune:finetune_classifier"
KW = dict(encoder_kind="htsat", n_cls=2, feat_dim=128, lr=1e-3, epochs=3, batch_size=8,
          seed=0, l2_strength=1e-3)


def _kw(args, **kw):
    return {**KW, "htsat_config": HTSATConfig(**TINY_HTSAT), "device": "cpu", **kw,
            **dict(zip(("x_train", "y_train", "x_val", "y_val", "x_test", "y_test"), args))}


def _dp_args():
    x, y = _clf_data("htsat", 32, seed=5)
    return x[:16], y[:16], x[16:24], y[16:24], x[24:], y[24:]


def _weighted_args():
    x, y = _clf_data("htsat", 40, seed=7)
    order = np.argsort(y[:28], kind="stable")
    return (x[:28][order], y[:28][order], x[28:34], y[28:34], x[34:], y[34:]), dict(
        class_weights=np.array([0.25, 1.75], np.float32), epochs=2)


@pytest.fixture(scope="module")
def runs():
    """Every world-2 run of this file from one launch (R.cases), and the
    one-device and JAX runs made in this process while the ranks work."""
    init = from_jax_classifier(_jax_init("htsat", seed=0)[1], "htsat")
    wargs, wkw = _weighted_args()
    x, y = _clf_data("htsat", 16, seed=1)
    cases = {"dp": ("call", dict(target=TRAINER, kwargs=_kw(_dp_args(), init_state=init))),
             **{f"weighted-{ps}": ("call", dict(target=TRAINER, kwargs=_kw(
                 wargs, param_sharding=ps, **wkw))) for ps in (None, "fsdp")},
             "odd": ("call", dict(target=TRAINER, expect="ValueError", kwargs=_kw(
                 (x[:8], y[:8], x[8:], y[8:]), batch_size=7)))}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, R.cases, 2, cases, device="cpu")
        hc = JHTSATConfig(enable_tscam=False, **TINY_HTSAT)
        out = {"jax": jft.finetune_classifier(
            *_dp_args(), encoder_kind="htsat", htsat_config=hc, mesh=data_parallel_mesh(2),
            **{k: v for k, v in KW.items() if k != "encoder_kind"})}
        out["one-dp"] = ft.finetune_classifier(**_kw(_dp_args(), init_state=init))
        out["one-weighted"] = ft.finetune_classifier(**_kw(wargs, **wkw))
        out.update(ranks.result())
    return out


def _params_close(a: dict, b: dict):
    """The JAX oracle's parameter bar (rtol 1e-2, atol 1e-3): Adam turns
    float noise in near-zero gradients into lr-sized moves."""
    for k, v in b.items():
        if v.is_floating_point():
            np.testing.assert_allclose(a[k].numpy(), v.numpy(), rtol=1e-2, atol=1e-3, err_msg=k)


def test_dp_finetune_matches_jax_dp_and_one_device(runs):
    """3 epochs at batch 8 over 2 ranks from the JAX init: the best epoch
    and the valid and test AUROC within 1e-3 (relative) of the JAX run on a
    2-device mesh and of the port's one-device run."""
    res, one = runs["dp"], runs["one-dp"]
    for other in (runs["jax"], one):
        assert res.best_epoch == other.best_epoch
        np.testing.assert_allclose(res.valid_auc, other.valid_auc, rtol=1e-3)
        np.testing.assert_allclose(res.test_auc, other.test_auc, rtol=1e-3)
    _params_close(res.state_dict, one.state_dict)


@pytest.mark.parametrize("param_sharding", [None, "fsdp"])
def test_weighted_loss_uneven_classes_padded_batch(runs, param_sharding):
    """loss="weighted" (class weights 0.25 / 1.75), 28 train clips (the
    last batch of each epoch padded with 4 rows) with the classes sorted so
    that the ranks see different mixes: the valid AUROC within 1e-3 of the
    one-device run, the same best epoch, the parameters at the JAX oracle's
    bar; DP and ZeRO-3."""
    res, one = runs[f"weighted-{param_sharding}"], runs["one-weighted"]
    assert res.best_epoch == one.best_epoch
    np.testing.assert_allclose(res.valid_auc, one.valid_auc, rtol=1e-3)
    _params_close(res.state_dict, one.state_dict)


def test_odd_batch_is_refused_before_any_rank_trains(runs):
    """batch_size 7 on 2 ranks: ValueError "not divisible" from the ranks'
    first check, before a model is built (the JAX case at
    tests/test_parallel.py:548)."""
    assert "not divisible" in runs["odd"]
