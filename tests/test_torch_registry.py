"""The port's checkpoint registry (extract/registry.py: _CP_PATHS,
get_encoder_path, get_audiomae_encoder_path, initialize_pretrained_model)
against the JAX package's: every name's path string, the errors of a
missing file or an unknown name, and a Lightning-style checkpoint written at
a continued-pretraining name's path, loaded by name in both packages (the
towers narrowed by patching both registries' Cola; the JAX package itself is
untouched). Also the port-only rules: a fine-tuned classifier's state_dict
loads as its encoder, cli.process takes every name, and the extract
package exports the JAX package's names."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heart_murmur_detection_tpu.extract.registry as jregistry
from heart_murmur_detection_tpu.models.cola import Cola as JCola
from heart_murmur_detection_tpu.models.htsat import HTSATConfig as JHTSATConfig
from heart_murmur_detection_tpu_torch import extract as port_extract
from heart_murmur_detection_tpu_torch.extract import registry
from heart_murmur_detection_tpu_torch.extract.extract import FeatureExtractor
from heart_murmur_detection_tpu_torch.models.cola import Cola
from heart_murmur_detection_tpu_torch.models.htsat import HTSATConfig, init_weights
from heart_murmur_detection_tpu_torch.train.finetune import EncoderClassifier

# the reference's depths (the JAX converter walks them) at narrow widths, on
# the full 256 x 256 geometry, so the tscam head exists
NARROW = dict(embed_dim=16, num_heads=(1, 2, 4, 8))
ALIASES = [f"operaCT-heart-{kind}-{s}" for kind in ("nonoisy", "cross")
           for s in ("zchsound_clean", "zchsound_noisy")]
ENCODER_NAMES = ["operaCT", "operaCE", "operaGT", *jregistry._CP_PATHS, *ALIASES]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_tables_are_the_jax_tables():
    assert registry._CP_PATHS == jregistry._CP_PATHS
    assert registry._AUDIOMAE_PATHS == jregistry._AUDIOMAE_PATHS
    assert len(ALIASES) == 4 and len(jregistry._CP_PATHS) == 14


def test_every_name_gives_the_jax_path(tmp_path, monkeypatch):
    """With a file at every path, each name resolves to the same string in
    both packages (the zchsound_clean / zchsound_noisy aliases included)."""
    monkeypatch.chdir(tmp_path)
    for p in [*jregistry._CP_PATHS.values(), *jregistry._AUDIOMAE_PATHS.values(),
              jregistry.ENCODER_PATH_OPERA_CT_HT_SAT, jregistry.ENCODER_PATH_OPERA_CE_EFFICIENTNET,
              jregistry.ENCODER_PATH_OPERA_GT_VIT]:
        os.makedirs(os.path.dirname(p), exist_ok=True)
        open(p, "w").close()
    paths = {}
    for name in ENCODER_NAMES:
        paths[name] = registry.get_encoder_path(name)
        assert paths[name] == jregistry.get_encoder_path(name), name
    for name in registry._AUDIOMAE_PATHS:
        assert registry.get_audiomae_encoder_path(name) == jregistry.get_audiomae_encoder_path(name)
    assert paths["operaCT-heart-cross-zchsound_noisy"] == jregistry._CP_PATHS[
        "operaCT-heart-cross-zchsound"]


@pytest.mark.parametrize("name", [*jregistry._CP_PATHS, *ALIASES, "audiomae-heart-all"])
def test_missing_checkpoint_names_the_jax_path(name, tmp_path, monkeypatch):
    """A missing file raises FileNotFoundError naming the JAX path, from
    the path functions, initialize_pretrained_model and the extractor
    cli.process builds."""
    monkeypatch.chdir(tmp_path)
    audiomae = name.startswith("audiomae")
    get, jget = ((registry.get_audiomae_encoder_path, jregistry.get_audiomae_encoder_path)
                 if audiomae else (registry.get_encoder_path, jregistry.get_encoder_path))
    with pytest.raises(FileNotFoundError) as want:
        jget(name)
    path = (jregistry._AUDIOMAE_PATHS if audiomae else jregistry._CP_PATHS).get(name) \
        or jregistry._CP_PATHS[name.replace("zchsound_clean", "zchsound").replace(
            "zchsound_noisy", "zchsound")]
    assert path in str(want.value)
    for call in (lambda: get(name), lambda: registry.initialize_pretrained_model(name),
                 lambda: FeatureExtractor(name, dim=768, device="cpu")):
        with pytest.raises(FileNotFoundError, match=re.escape(path)):
            call()


def test_unknown_names_raise_keyerror():
    for get in (registry.get_encoder_path, jregistry.get_encoder_path):
        with pytest.raises(KeyError):
            get("operaCT-heart-bogus")
    for get in (registry.get_audiomae_encoder_path, jregistry.get_audiomae_encoder_path):
        with pytest.raises(KeyError):
            get("audiomae-bogus")
    with pytest.raises(KeyError):
        registry.initialize_pretrained_model("operaCT-heart-bogus")


def test_cp_checkpoint_loads_by_name_in_both_packages(tmp_path, monkeypatch):
    """A Lightning-style checkpoint ({"state_dict", "epoch"}, the tscam head
    in it) at operaCT-heart-all's path: both registries load it by name
    (both building the narrow Cola); the JAX tree equals the port's weights
    and the two features agree at 1e-5."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HMDT_CACHE", str(tmp_path / "cache"))
    cfg = HTSATConfig(**NARROW)
    jcfg = JHTSATConfig(**NARROW)
    monkeypatch.setattr(registry, "Cola", lambda: Cola(cfg))
    monkeypatch.setattr(jregistry, "Cola", lambda config: JCola(config, htsat=jcfg))
    monkeypatch.setattr(jregistry, "_cached_init",
                        lambda kind, init_fn, cpu: jax.device_get(jax.jit(init_fn)()))
    src = Cola(cfg)
    init_weights(src, torch.Generator().manual_seed(3))
    path = jregistry._CP_PATHS["operaCT-heart-all"]
    os.makedirs(os.path.dirname(path))
    torch.save({"state_dict": src.state_dict(), "epoch": 159}, path)

    port = registry.initialize_pretrained_model("operaCT-heart-all")
    for k, t in src.state_dict().items():
        assert torch.equal(port.state_dict()[k], t), k
    jmodel, v = jregistry.initialize_pretrained_model("operaCT-heart-all")
    from heart_murmur_detection_tpu_torch.extract.convert import from_jax

    for k, t in from_jax(jax.device_get(v)).items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(t.numpy(), src.state_dict()[k].numpy(), err_msg=k)
    mel = np.random.default_rng(0).random((2, 251, 64)).astype(np.float32)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, method=JCola.encode))(v, jnp.asarray(mel))
    got = port.extract_feature(torch.from_numpy(mel), 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_finetuned_classifier_loads_as_its_encoder(tmp_path):
    """cli.finetune's `.pt` (an EncoderClassifier state_dict) read by name
    through ckpt_path: the HTS-AT takes the classifier's encoder, the
    projector keeps the seeded init (the JAX _adapt_msgpack_ckpt rule)."""
    cfg = HTSATConfig(**NARROW)
    clf = EncoderClassifier("htsat", 2, "linear", 128, cfg, generator=torch.Generator().manual_seed(5))
    path = str(tmp_path / "finetuning_linear_operaCT.pt")
    torch.save(clf.state_dict(), path)
    fresh = Cola(cfg)
    init_weights(fresh, torch.Generator().manual_seed(0))
    from heart_murmur_detection_tpu_torch.extract.convert import load_torch_ckpt

    got = load_torch_ckpt(path, Cola(cfg)).state_dict()
    for k, t in clf.encoder.state_dict().items():
        assert torch.equal(got["encoder.encoder.htsat." + k], t), k
    fresh_sd = fresh.state_dict()
    loaded = load_torch_ckpt(path, fresh).state_dict()
    for k in ("g.weight", "layer_norm.weight", "linear.weight"):
        assert torch.equal(loaded[k], fresh_sd[k])


def test_extract_exports_the_jax_names():
    for name in ("FeatureExtractor", "extract_opera_feature", "extract_audiomae_feature",
                 "get_encoder_path", "get_audiomae_encoder_path", "initialize_pretrained_model",
                 "convert", "registry"):
        assert hasattr(port_extract, name), name


def test_extract_audiomae_feature_matches_jax(tmp_path, monkeypatch):
    """extract_audiomae_feature on an Audio-MAE checkpoint by path, in both
    packages (the tower narrowed to width 128, depth 2 in both registries),
    float32 on the CPU."""
    import functools

    import heart_murmur_detection_tpu.extract.convert as jconvert
    from heart_murmur_detection_tpu.extract.extract import extract_audiomae_feature as j_feature
    from heart_murmur_detection_tpu.models import vit_mae as jvit
    from heart_murmur_detection_tpu_torch.models import vit_mae
    from heart_murmur_detection_tpu_torch.utils.audio_io import write_wav

    am = dict(embed_dim=128, depth=2, num_heads=2)
    monkeypatch.setattr(jregistry, "_cached_init",
                        lambda kind, init_fn, cpu: jax.device_get(jax.jit(init_fn)()))
    monkeypatch.setattr(jregistry, "audiomae_base_config",
                        lambda **kw: jvit.audiomae_base_config(**am, decoder_depth=2, **kw))
    monkeypatch.setitem(jconvert._CONVERTERS, "audiomae",
                        functools.partial(jconvert.convert_audiomae_backbone, depth=2))
    monkeypatch.setattr(vit_mae, "audiomae_base_config",
                        lambda **kw: vit_mae.MAEConfig(img_size=(1024, 128), patch_size=16, **am,
                                                       **kw))
    src = vit_mae.AudioMAEClassifierBackbone(vit_mae.audiomae_base_config())
    vit_mae.init_weights(src, torch.Generator().manual_seed(7))
    ckpt = str(tmp_path / "audiomae.pth")
    torch.save({"model": src.state_dict()}, ckpt)
    r = np.random.default_rng(9)
    wavs = []
    for i, sec in enumerate((4.0, 13.0)):
        wavs.append(str(tmp_path / f"c{i}.wav"))
        write_wav(wavs[-1], (0.3 * r.standard_normal(int(sec * 16000))).astype(np.float32), 16000)
    want = j_feature(wavs, ckpt_path=ckpt, batch_size=2, compute_dtype=jnp.float32)
    got = port_extract.extract_audiomae_feature(wavs, ckpt_path=ckpt, batch_size=2,
                                                compute_dtype=torch.float32, device="cpu")
    assert got.shape == want.shape == (2, 128)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
