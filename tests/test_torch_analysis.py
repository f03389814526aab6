"""The port's analysis tools, profiling, seeds, the rest of its DSP and
augmentation surface and its experiment scripts against the JAX package, on
numpy inputs made from a seed and weights carried by from_jax*:
analysis/saliency.py (the JAX mean-pool case; TINY_HTSAT in float32 through
saliency_for_linear_head, on the HTS-AT training forward with bn0 on its
running statistics), analysis/masked_spec.py (TINY_MAE with the JAX masking
noise), analysis/{rank,logs,embeddings}.py, utils/{profiling,seeds}.py,
audio/dsp.py (use_fft, resize_bicubic_static), audio/augment.py (the
device COLA augmentations on the JAX draws) and scripts/."""

import dataclasses
import glob
import importlib.util
import json
import os
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.analysis import embeddings as jemb
from heart_murmur_detection_tpu.analysis import logs as jlogs
from heart_murmur_detection_tpu.analysis import masked_spec as jmasked
from heart_murmur_detection_tpu.analysis import rank as jrank
from heart_murmur_detection_tpu.analysis import saliency as jsal
from heart_murmur_detection_tpu.audio import augment as jaug
from heart_murmur_detection_tpu.audio import dsp as jdsp
from heart_murmur_detection_tpu.models.htsat import HTSAT as JHTSAT
from heart_murmur_detection_tpu.models.vit_mae import MaskedAutoencoderViT as JMAE
from heart_murmur_detection_tpu.utils import seeds as jseeds
from heart_murmur_detection_tpu_torch.analysis import embeddings, logs, masked_spec, rank, saliency
from heart_murmur_detection_tpu_torch.audio import augment, dsp
from heart_murmur_detection_tpu_torch.extract import convert
from heart_murmur_detection_tpu_torch.models import vit_mae
from heart_murmur_detection_tpu_torch.models.heads import Head
from heart_murmur_detection_tpu_torch.models.htsat import HTSAT, HTSATConfig
from heart_murmur_detection_tpu_torch.utils import profiling, seeds
from heart_murmur_detection_tpu_torch.utils.logging import CSVLogger
from tests.test_pretrain import TINY_HTSAT, TINY_MAE

RTOL, ATOL = 1e-4, 1e-6  # saliency
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fields(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


# ---------------------------------------------------------------------------
# saliency
# ---------------------------------------------------------------------------


def test_mean_pool_saliency_matches_jax():
    """tests/test_analysis_evalckpts.py's case: a mean-pool "encoder" and a
    linear head, argmax and a given class."""
    W = np.random.default_rng(0).standard_normal((64, 3)).astype(np.float32)
    mel = np.random.default_rng(1).random((2, 32, 64)).astype(np.float32)
    for target in (None, 2):
        want, jcls = jsal.compute_saliency_map(lambda x: x.mean(axis=1) @ jnp.asarray(W), mel,
                                               target)
        got, cls = saliency.compute_saliency_map(lambda x: x.mean(1) @ torch.from_numpy(W), mel,
                                                 target)
        np.testing.assert_array_equal(cls, np.asarray(jcls))
        assert got.shape == mel.shape and (got >= 0).all()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def tiny_htsat():
    jm = JHTSAT(TINY_HTSAT)
    mel = np.random.default_rng(2).random((3, 70, 16)).astype(np.float32)
    v = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(mel)))
    # running statistics away from (0, 1), so the eval route is visible
    r = np.random.default_rng(3)
    v["batch_stats"]["bn0"] = {"mean": r.random(16).astype(np.float32) * 0.3,
                               "var": 0.5 + r.random(16).astype(np.float32)}
    sd = convert.from_jax({"params": {"encoder": v["params"]},
                           "batch_stats": {"encoder": v["batch_stats"]}})
    port = HTSAT(_fields(HTSATConfig, TINY_HTSAT))
    port.load_state_dict({k[len(convert.HTSAT_PREFIX):]: t for k, t in sd.items()})
    W = r.standard_normal((128, 4)).astype(np.float32) * 0.1
    b = r.standard_normal(4).astype(np.float32) * 0.1
    head = Head(4, "linear", 128)
    head.load_state_dict(convert.from_jax_head({"fc": {"kernel": W, "bias": b}}))
    return jm, v, port.eval(), {"fc": {"kernel": jnp.asarray(W), "bias": jnp.asarray(b)}}, head, mel


def test_htsat_saliency_matches_jax(tiny_htsat):
    """TINY_HTSAT in float32: the JAX eval forward's saliency against the
    port's training forward on running statistics (operact_encoder); the
    weights take no gradient and keep requires_grad."""
    jm, v, port, jhead, head, mel = tiny_htsat
    enc = jax.jit(lambda x: jm.apply(v, x)["latent_output"])
    want, jcls = jsal.saliency_for_linear_head(enc, jhead, mel)
    got, cls = saliency.saliency_for_linear_head(
        saliency.operact_encoder(port, torch.float32), head, mel)
    np.testing.assert_array_equal(cls, np.asarray(jcls))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * float(np.abs(want).max()))
    assert all(p.requires_grad and p.grad is None for p in port.parameters())


def test_one_backward_equals_per_clip_gradients(tiny_htsat):
    """The batch's one backward of sum_i logit[i, c_i] gives each clip's
    own gradient (eval-mode rows are independent), as the JAX vmap does."""
    _, _, port, _, head, mel = tiny_htsat
    apply = lambda x: head(saliency.operact_encoder(port, torch.float32)(x))
    got, cls = saliency.compute_saliency_map(apply, mel)
    for i in range(mel.shape[0]):
        one, c = saliency.compute_saliency_map(apply, mel[i : i + 1], int(cls[i]))
        np.testing.assert_allclose(got[i], one[0], rtol=RTOL, atol=ATOL * float(one.max()))


def test_bf16_saliency_tracks_float32(tiny_htsat, tmp_path):
    """The bf16 flow (the K8 route's plain versions on the CPU) against
    strict float32 for one class: the cosine of each clip's map; the figure
    writes."""
    _, _, port, _, head, mel = tiny_htsat
    bf, _ = saliency.saliency_for_linear_head(saliency.operact_encoder(port), head, mel, 1)
    f32, _ = saliency.saliency_for_linear_head(saliency.operact_encoder(port, torch.float32),
                                               head, mel, 1)
    for a, b in zip(bf, f32):
        assert float((a * b).sum() / np.linalg.norm(a) / np.linalg.norm(b)) > 0.99
    saliency.plot_saliency(mel[0], f32[0], "clip 0", str(tmp_path / "s.png"))
    assert os.path.exists(tmp_path / "s.png")


# ---------------------------------------------------------------------------
# masked-spectrogram reconstruction
# ---------------------------------------------------------------------------


def test_reconstruct_matches_jax(monkeypatch, tmp_path):
    """TINY_MAE on the JAX masking noise (captured from its draw): the
    masked image exactly, the reconstruction and the loss at 1e-5."""
    jm = JMAE(TINY_MAE)
    v = jax.device_get(jax.jit(jm.init)({"params": jax.random.PRNGKey(0),
                                         "masking": jax.random.PRNGKey(1)},
                                        jnp.zeros((1,) + TINY_MAE.img_size)))
    mel = np.random.default_rng(0).random(TINY_MAE.img_size).astype(np.float32)
    drawn = []
    uniform = jax.random.uniform

    def capture(*a, **k):
        drawn.append(np.asarray(uniform(*a, **k)))
        return drawn[-1]

    monkeypatch.setattr(jax.random, "uniform", capture)
    orig, jmasked_img, jrecon, jloss = jmasked.reconstruct(jm, v, mel, seed=3)
    monkeypatch.setattr(jax.random, "uniform", uniform)
    (noise,) = drawn
    port = vit_mae.MaskedAutoencoderViT(_fields(vit_mae.MAEConfig, TINY_MAE), decoder=True)
    port.load_state_dict(convert.from_jax_mae(v, decoder=True))
    got = masked_spec.reconstruct(port.eval(), mel, noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got[0], orig)
    np.testing.assert_array_equal(got[1], jmasked_img)
    np.testing.assert_allclose(got[2], jrecon, atol=1e-5)
    assert abs(got[3] - jloss) <= 1e-5
    # the visible patches come through the reconstruction unchanged
    np.testing.assert_array_equal(got[2][got[1] != 0], mel[got[1] != 0])
    # a seeded draw: the masked share, and the same seed gives the same mask
    a = masked_spec.reconstruct(port, mel, seed=5)
    b = masked_spec.reconstruct(port, mel, seed=5)
    np.testing.assert_array_equal(a[1], b[1])
    assert abs(float((a[1] == 0).mean()) - TINY_MAE.mask_ratio) < 0.1
    masked_spec.plot_reconstruction(*a[:3], path=str(tmp_path / "r" / "recon.png"))
    assert os.path.exists(tmp_path / "r" / "recon.png")


# ---------------------------------------------------------------------------
# host copies: rank, logs, embeddings
# ---------------------------------------------------------------------------


def test_rank_and_mrr_equal_jax():
    np.testing.assert_array_equal(rank.OPERA_RESULTS, jrank.OPERA_RESULTS)
    np.testing.assert_array_equal(rank.task_ranks(), jrank.task_ranks())
    np.testing.assert_array_equal(rank.mean_reciprocal_rank(), jrank.mean_reciprocal_rank())
    m = np.random.default_rng(4).random((19, 7))
    np.testing.assert_array_equal(rank.mean_reciprocal_rank(m), jrank.mean_reciprocal_rank(m))
    mrr = rank.print_mrr()
    assert mrr == jrank.print_mrr() and max(mrr, key=mrr.get) == "OPERA-CT"


def test_csv_log_equal_jax(tmp_path):
    lg = CSVLogger(str(tmp_path), "run")
    for e in range(3):
        lg.log(epoch=e, train_loss=1.5 / (e + 1), valid_loss=2.0 - e / 7, note="x")
    assert logs.read_csv_log(lg.path) == jlogs.read_csv_log(lg.path)
    logs.plot_log(lg.path, out_path=str(tmp_path / "p.png"))
    assert os.path.exists(tmp_path / "p.png")


def test_tsne_equal_jax(tmp_path):
    x = np.random.default_rng(5).standard_normal((40, 8)).astype(np.float32)
    np.testing.assert_array_equal(embeddings.tsne_embed(x, n_iter=250),
                                  jemb.tsne_embed(x, n_iter=250))
    pts, path = embeddings.plot_tsne(x, [i % 3 for i in range(40)], title="t",
                                     out_dir=str(tmp_path))
    assert pts.shape == (40, 2) and os.path.exists(path)


def test_melspectrogram_figure_array_equal_jax(tmp_path, monkeypatch):
    """plot_melspectrogram draws the same dB array as the JAX one (read off
    imshow)."""
    import matplotlib.axes

    shown = []
    real = matplotlib.axes.Axes.imshow
    monkeypatch.setattr(matplotlib.axes.Axes, "imshow",
                        lambda self, a, *k, **kw: (shown.append(np.array(a)), real(self, a, *k, **kw))[1])
    wav = np.sin(2 * np.pi * 440 * np.arange(16000) / 16000).astype(np.float32)
    wav += 0.01 * np.random.default_rng(6).standard_normal(16000).astype(np.float32)
    p = embeddings.plot_melspectrogram(wav, title="port", out_dir=str(tmp_path))
    jemb.plot_melspectrogram(wav, title="jax", out_dir=str(tmp_path))
    assert os.path.exists(p) and len(shown) == 2
    np.testing.assert_array_equal(shown[0], shown[1])


# ---------------------------------------------------------------------------
# profiling, seeds
# ---------------------------------------------------------------------------


def test_trace_annotate_and_step_timer(tmp_path, monkeypatch):
    with profiling.trace("off", out_dir=str(tmp_path), enabled=False):
        pass
    assert not os.path.exists(tmp_path / "off")
    with profiling.trace("unit", out_dir=str(tmp_path), enabled=True):
        with profiling.annotate("section"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "unit" / "trace.json") as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    assert "section" in names and any("mm" in n for n in names)
    monkeypatch.setenv("HMDT_TRACE", "1")
    with profiling.trace("env", out_dir=str(tmp_path)):
        torch.ones(3) * 2
    assert os.path.exists(tmp_path / "env" / "trace.json")
    t = profiling.step_timer()
    for _ in range(3):
        with t:
            pass
    assert t.count == 3 and t.total >= 0 and t.mean >= 0


def test_seeds_give_the_jax_draws():
    for s in (0, 17):
        gen = seeds.seed_everything(s)
        want_gen = torch.Generator().manual_seed(s)
        port = (random.random(), np.random.rand(3))
        assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=want_gen))
        jseeds.seed_everything(s)
        jax_draws = (random.random(), np.random.rand(3))
        assert port[0] == jax_draws[0]
        np.testing.assert_array_equal(port[1], jax_draws[1])
        np.testing.assert_array_equal(seeds.host_rng(s).random(5), jseeds.host_rng(s).random(5))


# ---------------------------------------------------------------------------
# DSP: use_fft, resize_bicubic_static; augment: the device COLA views
# ---------------------------------------------------------------------------


def test_use_fft_frontend_matches_jax():
    r = np.random.default_rng(7)
    lens = np.array([512 * 94, 16000 * 2 + 700], np.int32)
    wav = np.zeros((2, 512 * 94), np.float32)  # a multiple of the hop
    for i, n in enumerate(lens):
        wav[i, :n] = 0.3 * r.standard_normal(n)
    want, jnf = jdsp.mel_frontend(jnp.asarray(wav), jnp.asarray(lens), use_fft=True)
    got, nf = dsp.mel_frontend(torch.from_numpy(wav), torch.from_numpy(lens), use_fft=True)
    np.testing.assert_array_equal(nf.numpy(), np.asarray(jnf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    plain, _ = dsp.mel_frontend(torch.from_numpy(wav), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-4)
    x = torch.from_numpy(r.standard_normal((2, 4096)).astype(np.float32))
    np.testing.assert_array_equal(dsp.frame_half_hop(x, 1024).numpy(),
                                  np.asarray(jdsp.frame_half_hop(jnp.asarray(x.numpy()), 1024)))


@pytest.mark.parametrize("T,out", [(251, 1024), (1024, 256), (40, 41)])
def test_resize_bicubic_static_matches_jax(T, out):
    x = np.random.default_rng(T).random((2, T, 8)).astype(np.float32)
    want = jdsp.resize_bicubic_static(jnp.asarray(x), out)
    got = dsp.resize_bicubic_static(torch.from_numpy(x), out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_device_augmentations_on_the_jax_draws():
    """crop_at, mask_at and multiply_at on the uniforms the JAX functions
    draw give the JAX outputs; the torch-drawn pipeline keeps the shapes and
    ranges."""
    x = np.random.default_rng(8).random((300, 16)).astype(np.float32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        u = float(jax.random.uniform(key))
        np.testing.assert_array_equal(
            augment.crop_at(torch.from_numpy(x), torch.tensor(u), 64).numpy(),
            np.asarray(jaug.random_crop(key, jnp.asarray(x), 64)))
        k1, k2 = jax.random.split(key)
        u1, u2 = (np.asarray(jax.random.uniform(k, (300,))) for k in (k1, k2))
        for rates in ((0.1, 0.2), (0.3, 0.9)):
            want = np.asarray(jaug.random_mask(key, jnp.asarray(x), *rates))
            got = augment.mask_at(torch.from_numpy(x), torch.from_numpy(u1), torch.from_numpy(u2),
                                  *rates).numpy()
            np.testing.assert_array_equal(got == x, want == x)
            np.testing.assert_allclose(got, want, atol=1e-6)
        np.testing.assert_allclose(
            augment.multiply_at(torch.from_numpy(x), torch.tensor(u)).numpy(),
            np.asarray(jaug.random_multiply(key, jnp.asarray(x))), rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    x1, x2 = augment.cola_views(gen, torch.from_numpy(x), 64)
    assert x1.shape == x2.shape == (64, 16) and not torch.equal(x1, x2)
    gains = [float(augment.random_multiply(gen, torch.ones(1))) for _ in range(200)]
    assert 0.9 <= min(gains) and max(gains) <= 1.1


# ---------------------------------------------------------------------------
# the port's experiment scripts
# ---------------------------------------------------------------------------


def test_scripts_name_only_the_port():
    """One port script for each of scripts/*.sh (parity_real_weights needs
    the reference checkout, run_with_retry no script calls); each runs only
    the port's modules and the port's scripts, with the JAX script's keys."""
    port_dir = os.path.join(ROOT, "heart_murmur_detection_tpu_torch", "scripts")
    names = {os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "scripts", "*.sh"))}
    ported = {os.path.basename(p) for p in glob.glob(os.path.join(port_dir, "*.sh"))}
    assert ported == names - {"parity_real_weights.sh", "run_with_retry.sh"}
    for name in sorted(ported):
        text = open(os.path.join(port_dir, name)).read()
        jax_text = open(os.path.join(ROOT, "scripts", name)).read()
        assert not re.search(r"heart_murmur_detection_tpu\b(?!_torch)", text), name
        mods = re.findall(r"python -m (\S+)", text)
        assert mods == [m.replace("heart_murmur_detection_tpu.", "heart_murmur_detection_tpu_torch.")
                        for m in re.findall(r"python -m (\S+)", jax_text)], name
        for m in mods:
            assert importlib.util.find_spec(m) is not None, m
        for called in re.findall(r"sh (\S+\.sh)", text):
            assert called.startswith("heart_murmur_detection_tpu_torch/scripts/"), called
        keys = lambda t: sorted(set(re.findall(r"\b([A-Za-z_0-9]+)=", t)))
        assert keys(text) == keys(jax_text), name
