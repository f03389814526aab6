"""The openSMILE baseline of the port (audio/emobase.py, the host numpy
copy of the JAX package's emobase-988 fallback; models/vggish.py's
extract_opensmile_features / opensmile_impl; extract_and_save's opensmile
branch and its provenance sidecar) against the JAX package on synthetic
WAVs: tones, a chirp, noise and a clip shorter than one frame."""

import json
import warnings

import numpy as np
import pytest

from heart_murmur_detection_tpu.audio import emobase as jemo
from heart_murmur_detection_tpu.data.processors.common import extract_and_save as jextract_and_save
from heart_murmur_detection_tpu.models import vggish as jvggish
from heart_murmur_detection_tpu_torch.audio import emobase
from heart_murmur_detection_tpu_torch.data.processors.common import extract_and_save
from heart_murmur_detection_tpu_torch.models import vggish
from heart_murmur_detection_tpu_torch.utils.audio_io import write_wav

RTOL = 1e-6


def _clips():
    """(name, waveform, rate): a 220 Hz tone at 16 kHz, a 110 Hz tone with
    noise at 4 kHz, a chirp, white noise, and 10 ms of a tone (shorter than
    one 25-ms frame)."""
    r = np.random.default_rng(7)
    out = []
    for name, sr, sec in (("tone", 16000, 1.5), ("tone_noise", 4000, 2.0), ("chirp", 16000, 1.0),
                          ("noise", 16000, 0.8), ("short", 16000, 0.01)):
        t = np.arange(int(sr * sec)) / sr
        if name == "chirp":
            x = 0.4 * np.sin(2 * np.pi * (80 + 300 * t) * t)
        elif name == "noise":
            x = 0.1 * r.standard_normal(len(t))
        else:
            x = 0.5 * np.sin(2 * np.pi * (220 if name != "tone_noise" else 110) * t)
            if name == "tone_noise":
                x = x + 0.05 * r.standard_normal(len(t))
        out.append((name, x.astype(np.float32), sr))
    return out


@pytest.mark.parametrize("i", range(5))
def test_emobase_features_match_jax(i):
    """The 988 functionals and the 26 low-level descriptors of each clip,
    port copy against the JAX module, at rtol 1e-6."""
    name, x, sr = _clips()[i]
    got, want = emobase.emobase_features(x, sr), jemo.emobase_features(x, sr)
    assert got.shape == want.shape == (988,) and got.dtype == want.dtype == np.float32
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(), err_msg=name)
    np.testing.assert_allclose(emobase.emobase_lld(x, sr), jemo.emobase_lld(x, sr), rtol=RTOL,
                               atol=1e-12, err_msg=name)


def test_feature_names_and_functionals_match_jax():
    assert emobase.emobase_feature_names() == jemo.emobase_feature_names()
    c = np.random.default_rng(0).standard_normal(57)
    np.testing.assert_allclose(emobase.functionals(c), jemo.functionals(c), rtol=1e-12)


def test_opensmile_impl_and_the_fallback(tmp_path):
    """Without the pip package both packages report native-emobase; the
    port's extract_opensmile_features gives the (1, 988) row the JAX one
    puts in its DataFrame; native=False requires the pip package."""
    assert vggish.opensmile_impl() == jvggish.opensmile_impl() == "native-emobase"
    path = str(tmp_path / "a.wav")
    _, x, sr = _clips()[1]
    write_wav(path, x, sr)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = vggish.extract_opensmile_features(path)
        want = jvggish.extract_opensmile_features(path, native=True)
    assert got.shape == (1, 988)
    assert list(want.columns) == emobase.emobase_feature_names()
    np.testing.assert_allclose(got, want.to_numpy(), rtol=RTOL)
    with pytest.raises(ImportError):
        vggish.extract_opensmile_features(path, native=False)


def test_extract_and_save_opensmile_matches_jax(tmp_path):
    """extract_and_save(pretrain="opensmile") on a feature dir: the same
    opensmile_feature.npy as the JAX package's, and the provenance sidecar
    naming the implementation."""
    paths = []
    for name, x, sr in _clips()[:4]:
        p = str(tmp_path / f"{name}.wav")
        write_wav(p, x, sr)
        paths.append(p)
    out = {}
    for tag, fn in (("jax", jextract_and_save), ("torch", extract_and_save)):
        d = tmp_path / tag
        d.mkdir()
        np.save(d / "sound_dir_loc.npy", np.array(paths))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            kw = {} if tag == "jax" else {"device": "cpu"}
            out[tag] = fn(str(d), "opensmile", **kw)
        assert out[tag] == str(d / "opensmile_feature.npy")
        with open(d / "opensmile_feature.provenance.json") as f:
            assert json.load(f) == {"impl": "native-emobase"}
    got, want = np.load(out["torch"]), np.load(out["jax"])
    assert got.shape == (4, 988)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())
