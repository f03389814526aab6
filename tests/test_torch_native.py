"""The port's native host loader (utils/native.py, built from
native/hmdt_native.cpp at first use) against the JAX package's bindings of
the same source, its build rules, and the operaCT extractor's native route
against the JAX extractor's on the same weights."""

import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.extract.extract import FeatureExtractor as JFeatureExtractor
from heart_murmur_detection_tpu.utils import native as jnative
from heart_murmur_detection_tpu_torch.extract import convert
from heart_murmur_detection_tpu_torch.extract.extract import FeatureExtractor
from heart_murmur_detection_tpu_torch.utils import native
from heart_murmur_detection_tpu_torch.utils.audio_io import write_wav

SR = 16000
MAX_LEN, MIN_LEN = 32 * SR, 8 * SR


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write(path: str, x: np.ndarray, sr: int, fmt: int = 1, bits: int = 16):
    """A RIFF/WAVE file of (n,) or (n, ch) samples: PCM at 8/16/24/32 bits
    (fmt 1) or IEEE float (fmt 3)."""
    x = np.asarray(x, np.float64)
    x = x[:, None] if x.ndim == 1 else x
    if fmt == 3:
        data = x.astype("<f4" if bits == 32 else "<f8").tobytes()
    elif bits == 8:
        data = np.clip(x * 128 + 128, 0, 255).astype(np.uint8).tobytes()
    elif bits == 24:
        v = np.clip(x * 8388607, -8388608, 8388607).astype("<i4").ravel()
        data = b"".join(int(s & 0xFFFFFF).to_bytes(3, "little") for s in v)
    else:
        scale = {16: 32767, 32: 2147483647}[bits]
        data = np.clip(x * scale, -scale - 1, scale).astype(f"<i{bits // 8}").tobytes()
    ch, ba = x.shape[1], x.shape[1] * bits // 8
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, fmt, ch, sr, sr * ba, ba, bits)
    with open(path, "wb") as f:
        f.write(hdr + b"data" + struct.pack("<I", len(data)) + data)
    return path


def _signal(sec: float, f0: float, seed: int, sr: int = SR, silence: float = 0.5):
    r = np.random.default_rng(seed)
    t = np.arange(int(sec * sr)) / sr
    x = 0.4 * np.sin(2 * np.pi * f0 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 0.7 * t))
    x = x + 0.01 * r.standard_normal(len(t))
    pad = np.zeros(int(silence * sr))
    return np.concatenate([pad, x, pad])


FORMATS = [(1, 16, 1), (1, 8, 1), (1, 24, 2), (1, 32, 1), (3, 32, 2), (3, 64, 1)]


@pytest.mark.parametrize("fmt,bits,ch", FORMATS)
def test_decode_matches_jax(tmp_path, fmt, bits, ch):
    x = _signal(1.5, 220, bits)
    if ch == 2:
        x = np.stack([x, 0.5 * x[::-1]], 1)
    p = _write(str(tmp_path / "a.wav"), x, 22050, fmt, bits)
    got, want = native.decode_wav(p), jnative.decode_wav(p)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == 22050


@pytest.mark.parametrize("sec", [0.3, 3.0, 9.0, 40.0])
def test_trim_and_load_clip_match_jax(tmp_path, sec):
    """Clips shorter than the 8-s floor (both pad policies), between the
    floor and the 32-s cap, and past the cap."""
    p = str(tmp_path / "c.wav")
    write_wav(p, _signal(sec, 95, int(sec * 10)), SR)
    y, _ = native.decode_wav(p)
    assert native.trim_bounds(y, 1600, 800) == jnative.trim_bounds(y, 1600, 800)
    for pad_zero in (True, False):
        got = native.load_clip(p, MAX_LEN, MIN_LEN, pad_zero)
        want = jnative.load_clip(p, MAX_LEN, MIN_LEN, pad_zero)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])


def test_load_clip_rate_and_format_errors(tmp_path):
    p = str(tmp_path / "r.wav")
    write_wav(p, _signal(1.0, 95, 0, sr=4000), 4000)
    with pytest.raises(ValueError):
        native.load_clip(p, MAX_LEN, MIN_LEN)
    bad = tmp_path / "x.wav"
    bad.write_bytes(b"not a wav file at all" * 4)
    with pytest.raises(IOError):
        native.load_clip(str(bad), MAX_LEN, MIN_LEN)
    with pytest.raises(IOError):
        native.decode_wav(str(bad))


def test_prefetch_loader_matches_jax(tmp_path):
    paths = [str(tmp_path / f"p{i}.wav") for i in range(5)]
    for i, p in enumerate(paths):
        write_wav(p, _signal(2.0 + 4 * i, 80 + 20 * i, i), SR)
    kw = dict(batch_size=2, max_len=MAX_LEN, min_len=MIN_LEN, pad_zero=False)
    got = list(native.PrefetchLoader(paths, **kw))
    want = list(jnative.PrefetchLoader(paths, **kw))
    assert [(g[0], g[1]) for g in got] == [(w[0], w[1]) for w in want] == [(0, 2), (2, 2), (4, 1)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_array_equal(g[3], w[3])


def test_prefetch_loader_raises_a_load_error():
    def load(p):
        raise IOError(p)

    with pytest.raises(IOError):
        list(native.PrefetchLoader(["a", "b"], 2, 16, 8, loader=load))


def test_library_is_built_from_the_source_per_host(monkeypatch):
    """The loaded library is the build of this host (never the prebuilt
    native/libhmdt_native.so), and another CPU keys another build."""
    lib = native.load_native()
    assert os.path.realpath(lib._name).startswith(os.path.realpath(native.BUILD_DIR))
    key = native.build_key()
    monkeypatch.setattr(native, "_cpu_id", lambda: "model name : another host\n")
    assert native.build_key() != key


@pytest.mark.parametrize("case", ["compiler_error", "no_compiler"])
def test_failed_build_raises(tmp_path, monkeypatch, case):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++;\n" if case == "compiler_error" else "int x;\n")
    if case == "no_compiler":
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError):
        native.build(str(src), str(tmp_path / "build"))
    assert not any(f.endswith(".so") for _, _, fs in os.walk(tmp_path / "build") for f in fs)


def test_extractor_raises_when_the_build_fails(monkeypatch, tmp_path):
    """operaCT's whole-clip route needs the library: a failed build raises
    instead of falling back to the Python decoder."""
    ex = FeatureExtractor("operaCT", dim=768, batch_size=2, random_init=True,
                          compute_dtype=torch.float32, device="cpu")

    def fail(*args, **kwargs):
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native, "build", fail)
    native.load_native.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            ex.extract_files([str(tmp_path / "any.wav")])
    finally:
        native.load_native.cache_clear()


def test_native_route_matches_jax_extractor(tmp_path):
    """16-kHz WAVs through the C++ loader and a 4-kHz one through the Python
    decode + resample, in one operaCT extraction on the JAX extractor's
    weights: the JAX extractor's features at tests/test_torch_extract.py's
    tolerance, and the route counts."""
    paths = [str(tmp_path / f"w{i}.wav") for i in range(3)]
    for i, p in enumerate(paths[:2]):
        write_wav(p, _signal(5.0 + 4 * i, 90 + 15 * i, i), SR)
    write_wav(paths[2], _signal(7.0, 110, 9, sr=4000), 4000)
    jex = JFeatureExtractor("operaCT", dim=768, input_sec=8, batch_size=2, random_init=True,
                            compute_dtype=jnp.float32, use_fused_htsat=False)
    want = jex.extract_files(paths)
    ex = FeatureExtractor("operaCT", dim=768, input_sec=8, batch_size=2, random_init=True,
                          compute_dtype=torch.float32, device="cpu")
    ex.model.load_state_dict(convert.from_jax(jax.device_get(jex.variables)))
    got = ex.extract_files(paths)
    assert got.shape == (3, 768)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    assert ex.route_counts == {"native": 2, "python": 1}
