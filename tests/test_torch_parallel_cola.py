"""Data-parallel COLA continued pretraining on gloo ranks spawned on the CPU
(pretrain/cola_training.py with a parallel/mesh.py mesh): the HTS-AT at
world 2 against the JAX train_multiple_data on a 2-device mesh and against
the port's single-device run (strict float32: losses at rtol 1e-4, final
parameters at rtol 1e-3, as tests/test_torch_pretrain.py holds the
single-device loop); the bf16 plain flow against the single-device bf16
run (rtol 3e-2, the JAX package's bar); the EfficientNet's 49 BatchNorms'
running statistics against the single-device run's; resume of a DP and a
ZeRO-3 run against an uninterrupted one; fused_train with param_sharding
refused. Every world-2 run shares one launch of two ranks (R.cases), and the
single-device runs run in this process meanwhile."""

import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.models.cola import Cola as JaxCola
from heart_murmur_detection_tpu.models.cola import ColaConfig
from heart_murmur_detection_tpu.models.htsat import HTSATConfig as JaxHTSATConfig
from heart_murmur_detection_tpu.parallel.mesh import data_parallel_mesh
from heart_murmur_detection_tpu.pretrain import cola_training as jax_cola_training
from heart_murmur_detection_tpu.pretrain import data as jax_data
from heart_murmur_detection_tpu_torch.extract.convert import from_jax
from heart_murmur_detection_tpu_torch.models.htsat import HTSATConfig
from heart_murmur_detection_tpu_torch.parallel import launch
from heart_murmur_detection_tpu_torch.pretrain import cola_training, data
from tests import torch_parallel_ranks as R


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads in the test process (the ranks take one each):
    the test run shares the cores among its xdist workers (see
    test_torch_swin.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TINY = dict(spec_size=64, patch_size=4, embed_dim=16, depths=(1, 1, 1, 1),
            num_heads=(2, 2, 2, 2), window_size=2, mel_bins=16, drop_path_rate=0.0)
TRAINER = "heart_murmur_detection_tpu_torch.pretrain.cola_training:train_multiple_data"


def corpus(module=data, n_train=8, n_val=4, seed=0, n_mels=16):
    r = np.random.default_rng(seed)
    clip = lambda: r.random((int(r.integers(40, 90)), n_mels)).astype(np.float32)
    return module.Corpus("a", [clip() for _ in range(n_train)], [clip() for _ in range(n_val)],
                         32)


def _args(root, n_epoches, title="dp", **kw):
    return dict(title=title, data_source={"a": 32}, n_epoches=n_epoches, batch_size=4, seed=0,
                ckpt_root=str(root / "cks"), log_dir=str(root / "logs"), verbose=False,
                dropout_p=0.0, **kw)


def _one(root, **kw):
    """The port's loop on one device."""
    return cola_training.train_multiple_data(device="cpu", **_args(root, **kw))


@functools.lru_cache(maxsize=1)
def _jax_init():
    model = JaxCola(ColaConfig(encoder="htsat", p=0.0),
                    htsat=JaxHTSATConfig(enable_tscam=False, **TINY))
    dummy = jnp.zeros((1, 64, 16))
    init = jax.jit(lambda k: model.init(k, (dummy, dummy)))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


def _close_params(got: dict, want: dict, init: dict):
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        g, v = got[k].numpy(), v.numpy()
        if k.endswith("attn.qkv.bias"):
            # the key bias's exact gradient is 0 (a per-query constant of the
            # logits): Adam scales float noise to +-lr steps, held to Adam's
            # bound (tests/test_torch_pretrain.py)
            n = v.shape[0] // 3
            assert np.abs(g[n:2 * n] - init[k].numpy()[n:2 * n]).max() <= 4e-4 * (1 + 1e-6)
            g, v = np.delete(g, np.s_[n:2 * n]), np.delete(v, np.s_[n:2 * n])
        np.testing.assert_allclose(g, v, rtol=1e-3, atol=1e-3 * np.abs(v).max() + 1e-7,
                                   err_msg=k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world-2 run of this file from one launch (R.cases), and the
    single-device and JAX runs made in this process while the ranks work."""
    root = tmp_path_factory.mktemp("cola")
    init = from_jax(_jax_init())
    kw = {
        "f32": dict(corpora=[corpus()], htsat_config=HTSATConfig(**TINY), encoder="htsat",
                    initial_state=init, n_epoches=2),
        "bf16": dict(corpora=[corpus()], htsat_config=HTSATConfig(**TINY), encoder="htsat",
                     compute_dtype=torch.bfloat16, fused_train=False, n_epoches=1),
        "eff": dict(corpora=[corpus(n_train=4, n_mels=64)], encoder="efficientnet", n_epoches=1),
    }
    resume = lambda ps: dict(target=TRAINER, args8=_args(
        root / f"resume-{ps}", 8, corpora=[corpus()], htsat_config=HTSATConfig(**TINY),
        encoder="htsat", param_sharding=ps))
    cases = {**{k: ("call", dict(target=TRAINER, kwargs=_args(root / f"dp-{k}", **v)))
                for k, v in kw.items()},
             "resume-None": ("resume_runs", resume(None)),
             "resume-fsdp": ("resume_runs", resume("fsdp"))}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, R.cases, 2, cases, device="cpu")
        out = {"init": init}
        out.update({f"one-{k}": _one(root / f"one-{k}", **v) for k, v in kw.items()})
        eager_init = JaxCola.init
        JaxCola.init = lambda self, rng, *a: jax.jit(
            lambda r, xs: eager_init(self, r, *xs))(rng, a)
        try:
            jv, jh, _ = jax_cola_training.train_multiple_data(
                corpora=[corpus(jax_data)],
                htsat_config=JaxHTSATConfig(enable_tscam=False, **TINY),
                mesh=data_parallel_mesh(2), encoder="htsat", **_args(root / "jax", 2))
        finally:
            JaxCola.init = eager_init
        out["jax"] = jv, jh
        out.update(ranks.result())
    return out


def test_dp_cola_matches_jax_dp_and_the_single_device_run(runs):
    """2 epochs of 2 steps (8 train clips, batch 4 over 2 ranks), dropout and
    DropPath off, strict float32, from the JAX init: every epoch's train and
    valid loss at rtol 1e-4 of the JAX 2-device run's and of the port's
    single-device run's (the second epoch's valid loss runs on that epoch's
    weights: the eval layouts are rebuilt each eval); final parameters at
    rtol 1e-3 of both."""
    jv, jh = runs["jax"]
    init = runs["init"]
    sd, h, _ = runs["f32"]
    sd1, h1, _ = runs["one-f32"]
    assert [e["steps"] for e in h] == [2, 2] and [e["pairs"] for e in h] == [8, 8]
    for a, b, c in zip(h, jh, h1):
        for q in ("train_loss", "valid_loss"):
            np.testing.assert_allclose(a[q], b[q], rtol=1e-4)
            np.testing.assert_allclose(a[q], c[q], rtol=1e-4)
    _close_params(sd, from_jax(jax.tree.map(np.asarray, jv)), init)
    _close_params(sd, sd1, init)


def test_dp_bf16_plain_flow_tracks_the_single_device_run(runs):
    """The bf16 flow on the plain versions of the train kernels (the kernel
    route's CPU stand-in, fused_train=False) at world 2 tracks the
    single-device bf16 run within the JAX package's bf16 DP bar."""
    _, h, _ = runs["bf16"]
    _, h1, _ = runs["one-bf16"]
    np.testing.assert_allclose(h[-1]["train_loss"], h1[-1]["train_loss"], rtol=3e-2)
    np.testing.assert_allclose(h[-1]["valid_loss"], h1[-1]["valid_loss"], rtol=3e-2)


def test_dp_efficientnet_batchnorms_follow_the_global_batch(runs):
    """COLA on the EfficientNet (float32, drop-connect and dropout off), one
    step of batch 4 at world 2: the running statistics of all 49
    BatchNorms equal the single-device run's, as the losses do. (One step:
    Adam's first updates turn float noise in small gradients into whole-lr
    moves, which a second step's statistics would carry.)"""
    sd, h, _ = runs["eff"]
    sd1, h1, _ = runs["one-eff"]
    stats = [k for k in sd1 if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 49
    for k in stats:
        torch.testing.assert_close(sd[k], sd1[k], rtol=1e-5, atol=1e-6, msg=k)
    np.testing.assert_allclose(h[-1]["train_loss"], h1[-1]["train_loss"], rtol=1e-4)
    np.testing.assert_allclose(h[-1]["valid_loss"], h1[-1]["valid_loss"], rtol=1e-4)


@pytest.mark.parametrize("param_sharding", [None, "fsdp"])
def test_resume_equals_the_uninterrupted_run(runs, param_sharding):
    """DP and ZeRO-3 at world 2: resume=True from the resume checkpoint of
    epoch 4 of an 8-epoch run runs epochs [5, 6, 7] (as the JAX
    test_tp_resume_preserves_sharding), and its final state equals the
    uninterrupted run's: the checkpoint holds the full weights and (ZeRO-3)
    the Adam state gathered to full size, re-sharded on restore, and the
    sampler's and generators' state."""
    (h8, sd8), (hr, sdr) = runs[f"resume-{param_sharding}"]
    assert [e["epoch"] for e in h8] == list(range(8))
    assert [e["epoch"] for e in hr] == [5, 6, 7]
    for a, b in zip(hr, h8[5:]):
        assert (a["train_loss"], a["valid_loss"]) == (b["train_loss"], b["valid_loss"])
    for k, v in sd8.items():
        assert torch.equal(sdr[k], v), k


def test_fused_train_with_param_sharding_is_refused():
    """fused_train=True with param_sharding is a config error, as in the JAX
    package: ZeRO-3 runs the plain path."""
    with pytest.raises(ValueError, match="pure data parallelism"):
        cola_training.train_impl(torch.bfloat16, True, torch.device("cpu"), "fsdp")
    assert cola_training.train_impl(torch.bfloat16, None, torch.device("cuda"), "fsdp") == "plain"
    assert cola_training.train_impl(torch.bfloat16, None, torch.device("cuda")) == "kernel"
