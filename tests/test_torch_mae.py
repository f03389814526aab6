"""The port's MAE-family extraction (operaGT ViT-S, Audio-MAE ViT-B) against
the JAX package on the same numpy inputs and weights: the kaldi fbank and
its framing, the copied host helpers, the weight conversion, the encoder
forwards, the FeatureExtractor and the serving default of input_sec; plus
the reference-checkpoint loader and the fast-softmax guard. The towers run
here on the CPU at narrow widths and depth 2 (the configs both registries
build are patched; the JAX package itself is untouched)."""

import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heart_murmur_detection_tpu.extract.registry as jregistry
from heart_murmur_detection_tpu.audio import dsp as jdsp
from heart_murmur_detection_tpu.audio import pad as jpad
from heart_murmur_detection_tpu.audio import reference_np as jref
from heart_murmur_detection_tpu.data.processors.common import default_input_sec as j_default_sec
from heart_murmur_detection_tpu.extract import convert as jconvert
from heart_murmur_detection_tpu.extract.extract import FeatureExtractor as JFeatureExtractor
from heart_murmur_detection_tpu.models import vit_mae as jvit
from heart_murmur_detection_tpu_torch.audio import dsp, pad
from heart_murmur_detection_tpu_torch.audio import reference_np as ref
from heart_murmur_detection_tpu_torch.cli.serve import _build_extractor, make_server
from heart_murmur_detection_tpu_torch.extract import convert, registry
from heart_murmur_detection_tpu_torch.extract.extract import FeatureExtractor
from heart_murmur_detection_tpu_torch.models import vit_fused, vit_mae
from heart_murmur_detection_tpu_torch.utils.audio_io import write_wav


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the test run shares the cores among its xdist
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def synth(n, sr=16000, seed=0):
    r = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return (0.4 * np.sin(2 * np.pi * 60 * t) + 0.05 * r.standard_normal(n)).astype(np.float32)


# ---------------------------------------------------------------------------
# kaldi fbank frontend and the copied host helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("win,hop,T", [(400, 160, 12), (1024, 512, 5), (400, 160, 40)])
def test_frame_signal_matches_jax(win, hop, T):
    x = np.random.default_rng(win + T).standard_normal((2, 3000)).astype(np.float32)
    got = dsp.frame_signal(torch.from_numpy(x), win, hop, T).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdsp.frame_signal(jnp.asarray(x), win, hop, T)))


@pytest.mark.parametrize("wire_int16", [False, True])
def test_kaldi_fbank_matches_jax(wire_int16):
    lens = [10 * 16000, 3 * 16000 + 77, 399]  # the last is shorter than one frame
    clips = [synth(n, seed=i) for i, n in enumerate(lens)]
    batch, lengths = dsp.pad_batch(clips, dtype=np.int16 if wire_int16 else np.float32)
    got, nf = dsp.kaldi_fbank_frontend(torch.from_numpy(batch), torch.from_numpy(lengths))
    want, jnf = jdsp.kaldi_fbank_frontend(jnp.asarray(batch), jnp.asarray(lengths))
    np.testing.assert_array_equal(nf.numpy(), np.asarray(jnf))
    assert nf.tolist() == [998, 1 + (3 * 16000 + 77 - 400) // 160, 0]
    # float32 DFT and bank products summed in another order; the log of the
    # weakest bins turns their 1e-7 relative difference into up to ~3e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=5e-5)


def test_host_copies_identical():
    for n in (400, 512):
        np.testing.assert_array_equal(ref.hanning_symmetric(n), jref.hanning_symmetric(n))
    np.testing.assert_array_equal(ref.kaldi_mel_banks(128, 512, 16000),
                                  jref.kaldi_mel_banks(128, 512, 16000))
    x = synth(25 * 16000 + 321)
    for sec in (10, 8.18):
        got, want = pad.split_sample_simple(x, sec, 16000), jpad.split_sample_simple(x, sec, 16000)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pretrain", ["operaCT", "operaCE", "operaGT", "audiomae",
                                      "audiomae-heart-all", "clap"])
def test_default_input_sec_identical(pretrain):
    assert registry.default_input_sec(pretrain) == j_default_sec(pretrain)


# ---------------------------------------------------------------------------
# weights and encoder forwards
# ---------------------------------------------------------------------------

GT_SMALL = dict(img_size=(32, 16), patch_size=4, embed_dim=128, depth=2, num_heads=2)
AM_SMALL = dict(img_size=(64, 32), patch_size=8, embed_dim=128, depth=2, num_heads=2)


@pytest.fixture(scope="module")
def flax_mae():
    cfg = jvit.MAEConfig(**GT_SMALL, decoder_embed_dim=64, decoder_depth=2,
                         decoder_num_heads=2)
    model = jvit.MaskedAutoencoderViT(cfg)
    v = jax.jit(lambda: model.init({"params": jax.random.PRNGKey(0),
                                    "masking": jax.random.PRNGKey(1)},
                                   jnp.zeros((1, 32, 16))))()
    return model, jax.device_get(v)


@pytest.fixture(scope="module")
def flax_audiomae():
    model = jvit.AudioMAEClassifierBackbone(jvit.audiomae_base_config(**AM_SMALL))
    v = jax.jit(lambda: model.init(jax.random.PRNGKey(2), jnp.zeros((1, 48, 32))))()
    return model, jax.device_get(v)


def _np_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _eq_trees(a, b, path=""):
    assert set(a) == set(b), (path, set(a) ^ set(b))
    for k in a:
        if isinstance(a[k], dict):
            _eq_trees(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{path}/{k}")


def test_from_jax_mae_round_trip(flax_mae):
    _, v = flax_mae
    sd = convert.from_jax_mae(v)
    assert "norm.weight" in sd and not any(k.startswith("decoder") for k in sd)
    back = jconvert.convert_mae(_np_sd(sd), depth=2)["params"]
    enc = {k: x for k, x in v["params"].items() if not k.startswith(("decoder", "mask_token"))}
    _eq_trees(back, enc)
    model = vit_mae.MaskedAutoencoderViT(vit_mae.MAEConfig(**GT_SMALL))
    model.load_state_dict(sd)  # every key of the port's encoder, nothing else


def test_from_jax_audiomae_round_trip(flax_audiomae):
    _, v = flax_audiomae
    sd = convert.from_jax_mae(v)
    _eq_trees(jconvert.convert_audiomae_backbone(_np_sd(sd), depth=2)["params"], v["params"])
    vit_mae.AudioMAEClassifierBackbone(vit_mae.audiomae_base_config(**AM_SMALL)).load_state_dict(sd)


def test_sincos_pos_embed_identical():
    for dim, grid in ((384, (16, 64)), (768, (8, 64)), (128, (4, 8))):
        np.testing.assert_array_equal(vit_mae.sincos_pos_embed_flexible(dim, grid, True),
                                      jvit.sincos_pos_embed_flexible(dim, grid, True))


def test_mae_forward_feature_matches_flax(flax_mae):
    model_j, v = flax_mae
    x = np.random.default_rng(3).standard_normal((2, 32, 16)).astype(np.float32)
    want = np.asarray(model_j.apply(v, jnp.asarray(x), method=jvit.MaskedAutoencoderViT.forward_feature))
    model = vit_mae.MaskedAutoencoderViT(vit_mae.MAEConfig(**GT_SMALL))
    model.load_state_dict(convert.from_jax_mae(v))
    with torch.no_grad():
        got = model.forward_feature(torch.from_numpy(x)).numpy()
    fused = vit_fused.mae_forward_feature_fused(model, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(fused, want, atol=3e-5, rtol=1e-4)


def test_audiomae_backbone_matches_flax(flax_audiomae):
    model_j, v = flax_audiomae
    x = np.random.default_rng(4).standard_normal((2, 48, 32)).astype(np.float32)
    want = np.asarray(model_j.apply(v, jnp.asarray(x)))
    model = vit_mae.AudioMAEClassifierBackbone(vit_mae.audiomae_base_config(**AM_SMALL))
    model.load_state_dict(convert.from_jax_mae(v))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    fused = vit_fused.audiomae_backbone_fused(model, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(fused, want, atol=3e-5, rtol=1e-4)
    # the bf16 flow tracks the f32 path
    bf = vit_fused.audiomae_backbone_fused(model, torch.from_numpy(x), torch.bfloat16).numpy()
    assert np.sum(bf * want) / (np.linalg.norm(bf) * np.linalg.norm(want)) >= 0.999


# ---------------------------------------------------------------------------
# the reference-checkpoint loader and the registry
# ---------------------------------------------------------------------------


def test_load_mae_ckpt_by_key_name(tmp_path, flax_mae):
    _, v = flax_mae
    sd = convert.from_jax_mae(v)
    full = {f"encoder.{k}": t for k, t in sd.items()}
    full["encoder.pos_embed"] = torch.zeros(1, 33, 128)
    full["encoder.decoder_embed.weight"] = torch.zeros(64, 128)
    path = str(tmp_path / "gt.ckpt")
    torch.save({"state_dict": full}, path)
    model = vit_mae.MaskedAutoencoderViT(vit_mae.MAEConfig(**GT_SMALL))
    convert.load_mae_ckpt(path, model)
    for k, t in model.state_dict().items():
        assert torch.equal(t, sd[k]), k
    del full["encoder.norm.bias"]
    torch.save({"state_dict": full}, path)
    with pytest.raises(KeyError, match="lacks"):
        convert.load_mae_ckpt(path, model)


def test_load_audiomae_ckpt_fc_norm_fallback(tmp_path, flax_audiomae):
    _, v = flax_audiomae
    sd = convert.from_jax_mae(v)
    fc = sd.pop("fc_norm.weight"), sd.pop("fc_norm.bias")
    path = str(tmp_path / "am.pth")
    torch.save({"model": {**sd, "norm.weight": fc[0] * 2, "norm.bias": fc[1] + 1}}, path)
    model = vit_mae.AudioMAEClassifierBackbone(vit_mae.audiomae_base_config(**AM_SMALL))
    convert.load_mae_ckpt(path, model)  # an MAE checkpoint: fc_norm from norm
    assert torch.equal(model.fc_norm.weight, fc[0] * 2) and torch.equal(model.fc_norm.bias, fc[1] + 1)
    torch.save(sd, path)  # neither: ones and zeros
    convert.load_mae_ckpt(path, model)
    assert (model.fc_norm.weight == 1).all() and (model.fc_norm.bias == 0).all()
    # as the JAX converter does
    want = jconvert.convert_audiomae_backbone(_np_sd(sd), depth=2)["params"]["fc_norm"]
    np.testing.assert_array_equal(model.fc_norm.weight.detach().numpy(), want["scale"])


@pytest.mark.parametrize("pretrain", ["operaGT", "audiomae", "audiomae-heart-all"])
def test_missing_checkpoint_names_its_path(pretrain, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="cks/model|audioMAE"):
        registry.initialize_pretrained_model(pretrain)


# ---------------------------------------------------------------------------
# FeatureExtractor and serving against the JAX package (depth 2, narrow)
# ---------------------------------------------------------------------------

GT_TEST = dict(embed_dim=128, depth=2, num_heads=2)
AM_TEST = dict(embed_dim=128, depth=2, num_heads=2)


@pytest.fixture(scope="module")
def small_towers():
    """Both registries build narrow depth-2 towers at the real image sizes;
    the JAX registry's init runs under one jit (eagerly, its decoder alone
    took ~17 s of per-primitive compiles) and is not cached on disk."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jregistry, "_cached_init",
                   lambda kind, init_fn, cpu: jax.device_get(jax.jit(init_fn)()))
        mp.setattr(jregistry, "mae_vit_small_config", lambda **kw: jvit.mae_vit_small_config(
            **GT_TEST, decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=2, **kw))
        mp.setattr(jregistry, "audiomae_base_config", lambda **kw: jvit.audiomae_base_config(
            **AM_TEST, decoder_depth=2, **kw))
        mp.setattr(vit_mae, "mae_vit_small_config", lambda **kw: vit_mae.MAEConfig(**GT_TEST, **kw))
        mp.setattr(vit_mae, "audiomae_base_config",
                   lambda **kw: vit_mae.MAEConfig(img_size=(1024, 128), patch_size=16, **AM_TEST, **kw))
        yield


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mae_wavs")
    out = []
    for i, sec in enumerate((6.0, 12.5, 21.0)):
        p = str(d / f"c{i}.wav")
        write_wav(p, synth(int(sec * 16000), seed=10 + i), 16000)
        out.append(p)
    return out


def _pair(pretrain, small_towers, **kw):
    sec = registry.default_input_sec(pretrain)
    jex = JFeatureExtractor(pretrain, input_sec=sec, batch_size=2, random_init=True,
                            compute_dtype=jnp.float32)
    ex = FeatureExtractor(pretrain, input_sec=sec, batch_size=2, random_init=True,
                          compute_dtype=torch.float32, device="cpu", **kw)
    ex.model.load_state_dict(convert.from_jax_mae(jax.device_get(jex.variables)))
    return jex, ex


@pytest.mark.parametrize("pretrain", ["operaGT", "audiomae"])
def test_extract_files_matches_jax(pretrain, small_towers, wavs):
    jex, ex = _pair(pretrain, small_towers)
    want = jex.extract_files(wavs)
    got = ex.extract_files(wavs)
    assert got.shape == want.shape == (3, 128)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
    # the chunking: operaGT 50%-hop 8.18 s windows, audiomae 10 s windows
    n_chunks = [len(ex._chunks(p)) for p in wavs]
    assert n_chunks == ([1, 3, 5] if pretrain == "operaGT" else [1, 2, 3])
    # the bf16 flow on the CPU tracks the f32 path
    ex.compute_dtype = torch.bfloat16
    ex._fn = ex._build()
    bf = ex.extract_files(wavs)
    cos = np.sum(bf * got, 1) / (np.linalg.norm(bf, axis=1) * np.linalg.norm(got, axis=1))
    assert cos.min() >= 0.999


def test_fast_softmax_guard_recovers_vit(small_towers, wavs):
    """ViT logits are not LN-bounded: past the float32 exp range the
    unnormalised softmax makes the features non-finite, and _harvest re-runs
    the batch with the stable softmax."""
    kw = dict(input_sec=8.18, batch_size=2, random_init=True, compute_dtype=torch.float32,
              device="cpu")
    ex = FeatureExtractor("operaGT", fast_softmax=True, **kw)
    sd = ex.model.state_dict()
    sd["blocks.0.attn.qkv.weight"] *= 400.0
    ex.model.load_state_dict(sd)
    feats = ex.extract_files(wavs[:2])
    assert np.isfinite(feats).all() and ex._fn_stable is not None
    ex2 = FeatureExtractor("operaGT", fast_softmax=False, **kw)
    ex2.model.load_state_dict(sd)
    np.testing.assert_allclose(feats, ex2.extract_files(wavs[:2]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pretrain,sec", [("operaGT", 8.18), ("audiomae", 10), ("operaCT", 8)])
def test_serve_input_sec_defaults_by_tower(pretrain, sec, small_towers):
    ex = _build_extractor({"pretrain": pretrain, "random_init": True, "device": "cpu",
                           "input_sec": "None"})
    assert ex.input_sec == sec
    assert _build_extractor({"pretrain": pretrain, "random_init": True, "device": "cpu",
                             "input_sec": 9}).input_sec == 9


def test_serve_operagt_matches_offline(small_towers, wavs):
    srv = make_server({"pretrain": "operaGT", "batch_size": 2, "random_init": True,
                       "device": "cpu"}, port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        req = urllib.request.Request(url + "/extract", data=json.dumps({"paths": wavs}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            body = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    feats = np.asarray(body["features"], np.float32)
    assert feats.shape == (3, 128) and body["n"] == 3
    np.testing.assert_allclose(feats, srv.extractor.extract_files(wavs), atol=1e-5)
    assert os.path.exists(wavs[0])
