"""Data-parallel MAE continued pretraining on gloo ranks spawned on the CPU
(pretrain/mae_training.py with a parallel/mesh.py mesh): DP and ZeRO-3 at
world 2 against the JAX single-device fused run (which tests/
test_parallel.py:234 pins to the JAX DP run) and against the port's
single-device run, strict float32, fed the JAX loop's masking noise: every
epoch's train and valid loss at rtol 1e-4, final parameters at rtol 1e-3
(tests/test_torch_mae_train.py's bars). Each rank draws the noise of the
global batch and takes its rows (the fed draws are (B, L) of the global
batch, which R.Feed asserts). The world-2 runs and the fused_train refusal
share one launch; the single-device and JAX runs run in this process
meanwhile."""

import concurrent.futures

import jax
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.pretrain import data as jax_data
from heart_murmur_detection_tpu.pretrain import mae_training as jax_mae_training
from heart_murmur_detection_tpu_torch.extract import convert
from heart_murmur_detection_tpu_torch.parallel import launch
from heart_murmur_detection_tpu_torch.pretrain import data, mae_training
from tests import torch_parallel_ranks as R
from tests.test_torch_mae_train import ZERO_GRAD, _cfgs, _jax_step_noises, _jinit, synth_corpus


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads in the test process (the ranks take one each):
    the test run shares the cores among its xdist workers (see
    test_torch_swin.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TRAINER = "heart_murmur_detection_tpu_torch.pretrain.mae_training:mae_train_multiple_data"
EPOCHS = 3


def _common(root):
    return dict(title="tiny", data_source={"a": 32}, n_epoches=EPOCHS, training_method="mae",
                batch_size=4, seed=0, verbose=False, ckpt_root=str(root / "cks"),
                log_dir=str(root / "logs"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX single-device fused run and the port's runs (one device, DP
    and ZeRO-3 at world 2) from the same init, batches and noise, and the
    ranks' message of the fused_train refusal."""
    root = tmp_path_factory.mktemp("mae")
    jcfg, cfg = _cfgs(mask_ratio=0.7)
    corpus = lambda m: [synth_corpus("a", 4, 4, 20, 60, 16, 32, m, 3)]
    _, v0 = _jinit(jcfg)
    init = convert.from_jax_mae(v0, decoder=True)
    noises = _jax_step_noises(0, 2 * EPOCHS, 4, 32)
    kw = lambda tag, **extra: dict(corpora=corpus(data), config_override=cfg,
                                   initial_state=init, **_common(root / tag), **extra)
    # a Feed of its own for each run
    patch = lambda: (("heart_murmur_detection_tpu_torch.models.mae_train_fused",
                      "masking_noise", R.Feed(noises)),)
    cases = {tag: ("call", dict(target=TRAINER, kwargs=kw(tag, param_sharding=ps),
                                patches=patch()))
             for tag, ps in (("dp", None), ("zero3", "fsdp"))}
    cases["refused"] = ("call", dict(target=TRAINER, expect="ValueError", kwargs=dict(
        corpora=corpus(data), config_override=cfg, param_sharding="fsdp", fused_train=True,
        compute_dtype=torch.bfloat16, **_common(root / "refused"))))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, R.cases, 2, cases, device="cpu")
        jmodel = jax_mae_training.MaskedAutoencoderViT
        eager_init = jmodel.init
        jmodel.init = lambda self, rngs, *a: jax.jit(lambda xs: eager_init(self, rngs, *xs))(a)
        try:
            jv, jh, _ = jax_mae_training.mae_train_multiple_data(
                corpora=corpus(jax_data), config_override=jcfg, fused_train=True,
                **_common(root / "jax"))
        finally:
            jmodel.init = eager_init
        out = {"jax": (convert.from_jax_mae(jax.tree.map(np.asarray, jv), decoder=True), jh),
               "init": init}
        with R.patched(patch()):
            sd, h, _ = mae_training.mae_train_multiple_data(device="cpu", **kw("one"))
        out["one"] = sd, h
        got = ranks.result()
    out.update({tag: got[tag][:2] for tag in ("dp", "zero3")})
    out["refused"] = got["refused"]
    return out


def _close_params(got, want, init):
    for k, v in want.items():
        g, v = got[k].numpy(), v.numpy()
        # leaves whose exact gradient is 0 (tests/test_torch_mae_train.py):
        # Adam scales float noise to +-lr steps, held to Adam's bound
        noise_only = np.zeros(v.shape, bool)
        if k.endswith("attn.qkv.bias"):
            n = v.shape[0] // 3
            noise_only[n:2 * n] = True
        elif k.endswith(ZERO_GRAD):
            noise_only[:] = True
        step = np.abs(g - init[k].numpy())[noise_only]
        assert step.size == 0 or step.max() <= EPOCHS * 1e-4 * (1 + 1e-6), k
        g, v = g[~noise_only], v[~noise_only]
        if v.size:
            np.testing.assert_allclose(g, v, rtol=1e-3, atol=1e-3 * np.abs(v).max() + 1e-7,
                                       err_msg=k)


@pytest.mark.parametrize("tag", ["dp", "zero3"])
def test_mae_cp_at_world_2_matches_jax_and_one_device(runs, tag):
    sd, h = runs[tag]
    jsd, jh = runs["jax"]
    sd1, h1 = runs["one"]
    assert [e["epoch"] for e in h] == list(range(EPOCHS))
    assert [e["samples"] for e in h] == [4] * EPOCHS
    for a, b, c in zip(h, jh, h1):
        for q in ("train_loss", "valid_loss"):
            np.testing.assert_allclose(a[q], b[q], rtol=1e-4)
            np.testing.assert_allclose(a[q], c[q], rtol=1e-4)
    _close_params(sd, jsd, runs["init"])
    _close_params(sd, sd1, runs["init"])


def test_fused_train_with_param_sharding_is_refused(runs):
    """fused_train=True with param_sharding: ValueError in the ranks, as the
    JAX package refuses it (mae_training.py:113-118)."""
    assert "pure data parallelism" in runs["refused"]
