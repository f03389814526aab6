"""The port's COLA continued pretraining (pretrain/, train/checkpoints.py,
utils/logging.py, cli/pretrain.py) against the JAX package: the copied
sampler and augmentations bit for bit, the numpy split against sklearn's,
Adam with epoch decay and freeze_encoder='early' against optax, and 3 CP
steps of train_multiple_data against the JAX one on the same weights;
checkpoint names, resume and the CLI's refusals."""

import csv
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from heart_murmur_detection_tpu.audio import augment as jax_augment
from heart_murmur_detection_tpu.models.cola import Cola as JaxCola
from heart_murmur_detection_tpu.models.cola import ColaConfig
from heart_murmur_detection_tpu.models.htsat import HTSATConfig as JaxHTSATConfig
from heart_murmur_detection_tpu.pretrain import cola_training as jax_cola_training
from heart_murmur_detection_tpu.pretrain import data as jax_data
from heart_murmur_detection_tpu.pretrain import steps as jax_steps
from heart_murmur_detection_tpu_torch.audio import augment
from heart_murmur_detection_tpu_torch.cli import pretrain as cli_pretrain
from heart_murmur_detection_tpu_torch.extract.convert import from_jax, load_torch_ckpt
from heart_murmur_detection_tpu_torch.models.cola import Cola
from heart_murmur_detection_tpu_torch.models.htsat import HTSATConfig
from heart_murmur_detection_tpu_torch.pretrain import cola_training, data, steps


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the test run shares the cores among its xdist
    workers (see test_torch_swin.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# tests/test_pretrain.py's TINY_HTSAT, DropPath off
TINY = dict(spec_size=64, patch_size=4, embed_dim=16, depths=(1, 1, 1, 1),
            num_heads=(2, 2, 2, 2), window_size=2, mel_bins=16, drop_path_rate=0.0)


def synth_corpus(name, n, tmin, tmax, n_mels, max_len, seed=0, module=data):
    """tests/test_pretrain.py's synthetic corpus, as a Corpus of `module`."""
    r = np.random.default_rng(seed)
    clips = [r.random((int(t), n_mels)).astype(np.float32) for t in r.integers(tmin, tmax, n)]
    k = max(1, n // 10)
    return module.Corpus(name, clips[k:], clips[:k], max_len)


def test_augment_copies_match_the_originals():
    x = np.random.default_rng(0).standard_normal((90, 16)).astype(np.float32)
    for fn in ("np_random_crop", "np_random_mask", "np_random_multiply"):
        args = (x, 32) if fn == "np_random_crop" else (x,)
        a = getattr(augment, fn)(np.random.default_rng(3), *args)
        b = getattr(jax_augment, fn)(np.random.default_rng(3), *args)
        np.testing.assert_array_equal(a, b, err_msg=fn)


def test_sampler_gives_the_jax_batches_bit_for_bit():
    corpora = [synth_corpus("a", 40, 60, 100, 16, 32), synth_corpus("b", 13, 60, 100, 16, 20, 1)]
    jc = [synth_corpus("a", 40, 60, 100, 16, 32, module=jax_data),
          synth_corpus("b", 13, 60, 100, 16, 20, 1, module=jax_data)]
    ours = data.MultiCorpusSampler(corpora, 4, "cola", seed=7)
    theirs = jax_data.MultiCorpusSampler(jc, 4, "cola", seed=7)
    assert ours.steps_per_epoch == theirs.steps_per_epoch and ours.weights == theirs.weights
    for _ in range(12):
        (sa, (a1, a2)), (sb, (b1, b2)) = ours.next_batch(), theirs.next_batch()
        assert sa == sb
        np.testing.assert_array_equal(a1, b1)
        np.testing.assert_array_equal(a2, b2)
    for (sa, (a1, a2)), (sb, (b1, b2)) in zip(ours.val_batches(), theirs.val_batches()):
        assert sa == sb
        np.testing.assert_array_equal(a1, b1)
        np.testing.assert_array_equal(a2, b2)
    assert data.OPTIMAL_MAX_LEN_COLA == jax_data.OPTIMAL_MAX_LEN_COLA


@pytest.mark.parametrize("n", [1, 10, 37, 300])
def test_numpy_split_equals_sklearn(n):
    sk = pytest.importorskip("sklearn.model_selection")
    items = [f"clip{i}" for i in range(n)]
    if n == 1:  # sklearn refuses to leave the train set empty
        assert data.split_train_val(items) == ([], items)
        return
    tr, va = sk.train_test_split(items, test_size=0.1, random_state=1337)
    assert data.split_train_val(items, 0.1, 1337) == (tr, va)


def test_load_corpus_matches_the_jax_loader(tmp_path):
    r = np.random.default_rng(2)
    names = []
    for i in range(23):
        f = str(tmp_path / f"c{i}")
        np.save(f + ".npy", r.random((int(r.integers(40, 90)), 16)).astype(np.float32))
        names.append(f)
    manifest = str(tmp_path / "m.npy")
    np.save(manifest, np.asarray(names))
    a = data.load_corpus("circor", 32, manifest=manifest)
    b = jax_data.load_corpus("circor", 32, manifest=manifest)
    assert len(a.train) == len(b.train) == 20 and len(a.val) == len(b.val) == 3
    for x, y in zip(a.train + a.val, b.train + b.val):
        np.testing.assert_array_equal(x, y)


@functools.lru_cache(maxsize=1)
def _jax_init(seed=0, bins=16):
    """The JAX loop's init of the TINY Cola (numpy leaves; callers copy)."""
    model = JaxCola(ColaConfig(encoder="htsat", p=0.0),
                    htsat=JaxHTSATConfig(enable_tscam=False, **TINY))
    dummy = jnp.zeros((1, 64, bins))
    init = jax.jit(lambda k: model.init(k, (dummy, dummy)))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))


def test_adam_epoch_decay_and_early_freeze_match_optax():
    """3 updates with fixed gradients, 2 steps an epoch (the third at lr x
    0.99): every leaf as optax gives it, frozen leaves untouched."""
    variables = _jax_init()
    params = variables["params"]
    tx = jax_steps.make_frozen(jax_steps.adam_with_epoch_decay(2, lr=1e-3),
                               jax_cola_training._cola_early_freeze)
    model = Cola(htsat=HTSATConfig(**TINY))
    model.load_state_dict(from_jax(variables))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    opt = steps.adam_with_epoch_decay(
        steps.make_frozen(model, cola_training._cola_early_freeze), 2, lr=1e-3)
    state = tx.init(params)
    update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
        *tx.update(g, s, p)))
    r = np.random.default_rng(5)
    named = dict(model.named_parameters())
    for _ in range(3):
        grads = jax.tree.map(lambda p: r.standard_normal(p.shape).astype(np.float32), params)
        params, state = update(grads, state, params)
        opt.zero_grad()
        for k, g in from_jax({"params": grads}).items():
            named[k].grad = g.clone()
        opt.step()
    want = from_jax({"params": params, "batch_stats": variables["batch_stats"]})
    got = model.state_dict()
    frozen = [k for k in named if not cola_training._cola_early_freeze(k)]
    assert any(".bn0." in k for k in frozen) and any(".layers.0.blocks." in k for k in frozen)
    for k in named:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for k in frozen:
        assert torch.equal(got[k], start[k]), k
    assert opt.count == 3 and opt.current_lr() == pytest.approx(1e-3 * 0.99)


def _cp_args(tmp_path, n_epoches, title="tiny"):
    return dict(title=title, data_source={"a": 32}, encoder="htsat", n_epoches=n_epoches,
                batch_size=4, seed=0, ckpt_root=str(tmp_path / "cks"),
                log_dir=str(tmp_path / "logs"), verbose=False, dropout_p=0.0)


def test_three_cp_steps_match_jax(tmp_path, monkeypatch):
    """3 epochs of one step each (4 train clips, batch 4), dropout and
    DropPath off, strict float32: per-step train losses and the eval losses
    at rtol 1e-4, final parameters at rtol 1e-3, as the JAX loop gives them."""
    # the JAX loop inits its Cola eagerly, which compiles every primitive
    # apart (~30 s on the CPU); the same init under one jit takes ~2 s
    eager_init = JaxCola.init
    monkeypatch.setattr(JaxCola, "init", lambda self, rng, *a: jax.jit(
        lambda r, xs: eager_init(self, r, *xs))(rng, a))
    jcfg = JaxHTSATConfig(enable_tscam=False, **TINY)
    jv, jh, _ = jax_cola_training.train_multiple_data(
        corpora=[synth_corpus("a", 5, 40, 90, 16, 32, module=jax_data)],
        htsat_config=jcfg, **_cp_args(tmp_path / "jax", 3))
    sd, h, _ = cola_training.train_multiple_data(
        corpora=[synth_corpus("a", 5, 40, 90, 16, 32)], htsat_config=HTSATConfig(**TINY),
        device="cpu", initial_state=from_jax(_jax_init()), **_cp_args(tmp_path / "port", 3))
    assert [e["epoch"] for e in h] == [0, 1, 2] and [e["steps"] for e in h] == [1, 1, 1]
    for a, b in zip(h, jh):
        np.testing.assert_allclose(a["train_loss"], b["train_loss"], rtol=1e-4)
        np.testing.assert_allclose(a["valid_loss"], b["valid_loss"], rtol=1e-4)
    want = from_jax(jax.tree.map(np.asarray, jv))
    init = from_jax(_jax_init())
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        got, v = sd[k].numpy(), v.numpy()
        if k.endswith("attn.qkv.bias"):
            # the key bias adds a per-query constant to the logits, so its
            # gradient is 0 in exact arithmetic and Adam scales float noise
            # to +-lr steps in either package: held to Adam's bound, 3 lr
            n = v.shape[0] // 3
            assert np.abs(got[n:2 * n] - init[k].numpy()[n:2 * n]).max() <= 3e-4 * (1 + 1e-6)
            got, v = np.delete(got, np.s_[n:2 * n]), np.delete(v, np.s_[n:2 * n])
        np.testing.assert_allclose(got, v, rtol=1e-3, atol=1e-3 * np.abs(v).max() + 1e-7,
                                   err_msg=k)
    with open(tmp_path / "port" / "logs" / "combined" / "tiny" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 3 and "train0_loss" in rows[0] and "valid_loss" in rows[0]


def test_checkpoint_names_after_ten_epochs_and_resume(tmp_path):
    """Top-k files land on epoch 9 under the JAX package's names (.ckpt),
    load into the extractor's Cola by name; last.ckpt resumes the run."""
    kw = dict(corpora=[synth_corpus("a", 5, 40, 90, 16, 32)], htsat_config=HTSATConfig(**TINY),
              device="cpu")
    sd, h, best = cola_training.train_multiple_data(**kw, **_cp_args(tmp_path, 10))
    assert len(h) == 10 and best is not None and os.path.exists(best)
    assert re.fullmatch(r"encoder-tiny-epoch=09--valid_acc=\d\.\d\d-valid_loss=\d+\.\d{4}\.ckpt",
                        os.path.basename(best))
    assert os.path.dirname(best) == str(tmp_path / "cks" / "a")
    model = load_torch_ckpt(best, Cola(htsat=HTSATConfig(**TINY)))
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    last = tmp_path / "cks" / "a" / "tiny" / "last.ckpt"
    assert last.exists()
    # nothing left to run: the restored state comes back as saved
    sd2, h2, _ = cola_training.train_multiple_data(**kw, resume=True, **_cp_args(tmp_path, 10))
    assert h2 == [] and all(torch.equal(sd2[k], sd[k]) for k in sd)
    sd3, h3, _ = cola_training.train_multiple_data(**kw, resume=True, **_cp_args(tmp_path, 11))
    assert [e["epoch"] for e in h3] == [10]


def test_early_freeze_keeps_frozen_weights_and_updates_bn0_stats(tmp_path):
    init = from_jax(_jax_init())
    sd, _, _ = cola_training.train_multiple_data(
        corpora=[synth_corpus("a", 5, 40, 90, 16, 32)], htsat_config=HTSATConfig(**TINY),
        device="cpu", initial_state=init, freeze_encoder="early", **_cp_args(tmp_path, 1))
    enc = "encoder.encoder.htsat."
    for k in (enc + "bn0.weight", enc + "layers.0.blocks.0.attn.qkv.weight"):
        assert torch.equal(sd[k], init[k]), k
    assert not torch.equal(sd[enc + "bn0.running_mean"], init[enc + "bn0.running_mean"])
    assert not torch.equal(sd[enc + "patch_embed.proj.weight"], init[enc + "patch_embed.proj.weight"])


@pytest.mark.parametrize("argv,exc", [
    (["method=mae", "covidbreath=True", "dp=2"], NotImplementedError),
    (["encoder=htsat", "circor=True", "dp=2"], NotImplementedError),
    (["encoder=efficientnet", "circor=True", "dp=2"], NotImplementedError),
    (["encoder=htsat"], SystemExit),
])
def test_cli_refusals(argv, exc, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(exc):
        cli_pretrain.main(argv)


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cola_training.train_multiple_data(
            corpora=[synth_corpus("a", 5, 40, 90, 16, 32)], htsat_config=HTSATConfig(**TINY),
            device="cuda", **_cp_args(tmp_path, 1))
