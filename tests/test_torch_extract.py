"""The port's FeatureExtractor and serving daemon (CPU, plain versions)
against the JAX package on the same weights, the options the slice does not
carry, the config-loader copy, and an import check that the port never
pulls in JAX."""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.cli import config as jconfig
from heart_murmur_detection_tpu.extract.extract import FeatureExtractor as JFeatureExtractor
from heart_murmur_detection_tpu_torch.cli import config
from heart_murmur_detection_tpu_torch.cli.serve import _build_extractor, _warm, make_server
from heart_murmur_detection_tpu_torch.data.processors.common import extract_and_save
from heart_murmur_detection_tpu_torch.extract import convert
from heart_murmur_detection_tpu_torch.extract.extract import FeatureExtractor
from heart_murmur_detection_tpu_torch.utils.audio_io import write_wav

@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the test run shares the cores among its xdist
    workers, and torch's default of one spinning thread per core starves
    them (the port's tests took 4x the CPU time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wav(path, sec, f0, sr=16000):
    r = np.random.default_rng(int(f0))
    t = np.arange(int(sec * sr)) / sr
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.02 * r.standard_normal(len(t))
    write_wav(path, x.astype(np.float32), sr)
    return path


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    return [_wav(str(d / f"c{i}.wav"), 6.0 + 3 * i, 80 + 10 * i) for i in range(3)]


@pytest.fixture(scope="module")
def jax_extractor():
    return JFeatureExtractor(
        "operaCT", dim=768, input_sec=8, batch_size=2, random_init=True,
        compute_dtype=jnp.float32, use_fused_htsat=False,
    )


def _port_like(jex, **kw):
    """A port extractor (CPU, f32) holding the JAX extractor's weights."""
    ex = FeatureExtractor("operaCT", dim=jex.dim, input_sec=8, batch_size=2,
                          random_init=True, compute_dtype=torch.float32, device="cpu", **kw)
    ex.model.load_state_dict(convert.from_jax(jax.device_get(jex.variables)))
    return ex


def test_extract_files_matches_jax(wavs, jax_extractor):
    want = jax_extractor.extract_files(wavs)
    got = _port_like(jax_extractor).extract_files(wavs)
    assert got.shape == (3, 768)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_dim_512_matches_jax(wavs):
    """operaCT 512-d features take the reference's route in both packages:
    the JAX extractor fuses only dim 768, so its 512-d features come from
    the float32 Cola.extract_feature graph, and so do the port's, whatever
    compute_dtype says. Same weights (from_jax) and WAVs; features scaled to
    unit max: max|d| <= 1e-4 and cosine >= 0.99999 (the strict f32 class)."""
    jex = JFeatureExtractor("operaCT", dim=512, input_sec=8, batch_size=2, random_init=True)
    want = jex.extract_files(wavs)
    ex = FeatureExtractor("operaCT", dim=512, input_sec=8, batch_size=2, random_init=True,
                          compute_dtype=torch.bfloat16, device="cpu")
    ex.model.load_state_dict(convert.from_jax(jax.device_get(jex.variables)))
    got = ex.extract_files(wavs)
    assert got.shape == want.shape == (3, 512)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale <= 1e-4
    cos = np.sum(got * want, 1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    assert cos.min() >= 0.99999


def test_dim_512_and_bf16_flow(wavs, jax_extractor):
    """A 512-d extractor asked for the bf16 flow gives g of the latent: it
    runs the float32 graph (test_dim_512_matches_jax), so it tracks g of
    the port's own f32 768-d latent."""
    ex = _port_like(jax_extractor)
    f768 = ex.extract_files(wavs)
    ex512 = FeatureExtractor("operaCT", dim=512, batch_size=2, random_init=True,
                             compute_dtype=torch.bfloat16, device="cpu")
    ex512.model.load_state_dict(ex.model.state_dict())
    f512 = ex512.extract_files(wavs)
    assert f512.shape == (3, 512) and np.isfinite(f512).all()
    # g of the bf16-flow latent tracks g of the f32 latent
    with torch.no_grad():
        g32 = ex.model.g(torch.from_numpy(f768)).numpy()
    cos = float(np.sum(f512 * g32) / (np.linalg.norm(f512) * np.linalg.norm(g32)))
    assert cos >= 0.999


def test_batch_padding_does_not_change_features(wavs, jax_extractor):
    a = _port_like(jax_extractor).extract_files(wavs)
    ex = _port_like(jax_extractor)
    ex.batch_size = 4
    np.testing.assert_allclose(ex.extract_files(wavs), a, atol=1e-5)


def test_fast_softmax_guard_recovers(wavs):
    """Attention logits past the float32 exp range make the unnormalised
    softmax non-finite; _harvest re-runs the batch with the stable softmax."""
    kw = dict(dim=768, batch_size=2, random_init=True, compute_dtype=torch.float32, device="cpu")
    ex = FeatureExtractor("operaCT", fast_softmax=True, **kw)
    sd = ex.model.state_dict()
    sd["encoder.encoder.htsat.layers.0.blocks.0.attn.qkv.weight"] *= 400.0
    ex.model.load_state_dict(sd)
    feats = ex.extract_files(wavs)
    assert np.isfinite(feats).all() and ex._fn_stable is not None
    ex2 = FeatureExtractor("operaCT", fast_softmax=False, **kw)
    ex2.model.load_state_dict(sd)
    np.testing.assert_allclose(feats, ex2.extract_files(wavs), rtol=1e-5, atol=1e-6)


def test_prefetch_iter_order_and_errors():
    got = list(FeatureExtractor._prefetch_iter(iter(range(17)), depth=3))
    assert got == list(range(17))

    def boom():
        yield 1
        raise ValueError("pack failed")

    out = []
    with pytest.raises(ValueError, match="pack failed"):
        for v in FeatureExtractor._prefetch_iter(boom(), depth=2):
            out.append(v)
    assert out == [1]


@pytest.mark.parametrize("kw", [
    {"baseline": "vggish"}, {"baseline": "opensmile"}, {"mesh": object()}, {"dim": 1280},
])
def test_uncarried_options_raise(kw, tmp_path):
    """What the port does not carry raises: VGGish weights (the repository
    has no VGGish checkpoint: FileNotFoundError without random_init), the
    pip openSMILE package when required (ImportError: the port carries the
    emobase fallback), and NotImplementedError for a mesh and operaCT at dim
    1280."""
    if "baseline" in kw:
        np.save(tmp_path / "sound_dir_loc.npy", np.array(["x.wav"]))
        if kw["baseline"] == "vggish":
            with pytest.raises(FileNotFoundError, match="VGGish weights"):
                extract_and_save(str(tmp_path), "vggish", device="cpu")
        else:
            from heart_murmur_detection_tpu_torch.models.vggish import (
                extract_opensmile_features)

            with pytest.raises(ImportError):
                extract_opensmile_features(str(tmp_path / "x.wav"), native=False)
        return
    args = dict(dim=768, random_init=True, device="cpu")
    args.update(kw)
    with pytest.raises(NotImplementedError):
        FeatureExtractor("operaCT", **args)


@pytest.mark.parametrize("source_sr", [3000, 3200, 44100])
def test_source_sr_must_divide_with_a_power_of_two_ratio(source_sr):
    """The JAX package's rule (extract.py:134-139): 16000 / source_sr an
    integer power of two of at most 512, else ValueError, in both."""
    with pytest.raises(ValueError, match="power-of-two"):
        FeatureExtractor("operaCT", dim=768, random_init=True, device="cpu", source_sr=source_sr)
    with pytest.raises(ValueError):
        JFeatureExtractor("operaCT", dim=768, random_init=True, source_sr=source_sr)


@pytest.mark.parametrize("pretrain", ["operaCE"])
def test_other_towers_raise(pretrain):
    """operaCE extracts at 1280 (the default) or 512 only; a kind without an
    extractor raises."""
    with pytest.raises(NotImplementedError, match="operaCE dim 768"):
        FeatureExtractor(pretrain, dim=768, random_init=True, device="cpu")
    with pytest.raises(NotImplementedError, match="no extractor"):
        FeatureExtractor("vggish", random_init=True, device="cpu")
    assert FeatureExtractor(pretrain, random_init=True, device="cpu").dim == 1280


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        FeatureExtractor("operaCT", dim=768, random_init=True)


def test_serve_source_sr_key():
    """The daemon's source_sr key (the JAX cli/serve.py:59-68) reaches the
    extractor, and the warm-up clip is written at that rate."""
    ex = _build_extractor({"pretrain": "operaCT", "dim": 768, "batch_size": 1,
                           "random_init": True, "source_sr": 4000, "device": "cpu"})
    assert ex.source_sr == 4000 and ex._host_sr == 4000
    before = ex.n_dispatched
    _warm(ex)
    assert ex.n_dispatched == before + 1


def test_config_copy_matches_original():
    argv = ["pretrain=operaCT", "dim=512", "random_init=True", "input_sec=None"]
    assert list(config.resolve("serve_config", argv)) == list(jconfig.resolve("serve_config", argv))
    assert config.parse_overrides(["-m", "a=1,2", "b=x"]) == jconfig.parse_overrides(["-m", "a=1,2", "b=x"])


# ---------------------------------------------------------------------------
# serving daemon (as tests/test_serve.py does for the JAX package)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def server():
    cfg = {"pretrain": "operaCT", "dim": 768, "input_sec": 8, "batch_size": 2,
           "random_init": True, "device": "cpu"}
    srv = make_server(cfg, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", srv
    srv.shutdown()
    srv.server_close()
    t.join(timeout=30)


def _post(url, data, ctype):
    req = urllib.request.Request(url + "/extract", data=data, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def test_serve_healthz(server):
    url, _ = server
    with urllib.request.urlopen(url + "/healthz") as r:
        body = json.loads(r.read())
    assert body == {"status": "ok", "pretrain": "operaCT", "dim": 768}


def test_serve_paths_match_offline(server, wavs):
    url, srv = server
    body = _post(url, json.dumps({"paths": wavs}).encode(), "application/json")
    feats = np.asarray(body["features"], np.float32)
    assert feats.shape == (3, 768) and body["n"] == 3
    np.testing.assert_allclose(feats, srv.extractor.extract_files(wavs), atol=1e-5)


def test_serve_wav_bytes(server, wavs):
    url, srv = server
    with open(wavs[1], "rb") as f:
        body = _post(url, f.read(), "audio/wav")
    feats = np.asarray(body["features"], np.float32)
    assert feats.shape == (1, 768)
    np.testing.assert_allclose(feats[0], srv.extractor.extract_files(wavs)[1], atol=1e-4)


def test_serve_errors(server):
    url, _ = server
    for data, ctype, code in (
        (json.dumps({"paths": ["/nonexistent/x.wav"]}).encode(), "application/json", 400),
        (json.dumps({"paths": []}).encode(), "application/json", 400),
        (b"x", "text/plain", 415),
    ):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, data, ctype)
        assert e.value.code == code
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nope")
    assert e.value.code == 404


# ---------------------------------------------------------------------------
# the port never imports JAX
# ---------------------------------------------------------------------------


def test_port_imports_no_jax():
    pkg = os.path.join(REPO, "heart_murmur_detection_tpu_torch")
    mods = []
    for root, dirs, files in os.walk(pkg):
        # only subpackages: not csrc/ or build outputs
        dirs[:] = [d for d in dirs if os.path.exists(os.path.join(root, d, "__init__.py"))]
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3].replace(os.sep, ".")
                mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    code = (
        "import importlib, sys\n"
        f"for m in {sorted(mods)!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'jaxlib'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 20
    pkg = "heart_murmur_detection_tpu_torch."
    assert {pkg + m for m in ("ops.vit", "models.vit_mae", "models.vit_fused",
                               "extract.registry", "audio.dsp")} <= set(mods)
