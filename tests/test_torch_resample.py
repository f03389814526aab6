"""The port's polyphase resampler (CPU) against scipy.signal.resample_poly and
the JAX package's resample_poly_device, its lengths, and a source_sr=4000
extraction against the 16 kHz host path."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

from heart_murmur_detection_tpu.ops import resample as jresample
from heart_murmur_detection_tpu_torch.extract.extract import FeatureExtractor
from heart_murmur_detection_tpu_torch.ops.resample import (
    resample_poly_device,
    resampled_length,
    resampled_lengths,
)
from heart_murmur_detection_tpu_torch.utils.audio_io import load_wav, write_wav

ATOL = 3e-5  # tests/test_resample.py's bar: float32 round-off of the FIR sums
CASES = [(4, 1), (8, 1), (2, 1), (1, 2), (3, 2), (160, 441)]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("up,down", CASES)
def test_matches_scipy(up, down):
    x = np.random.default_rng(0).standard_normal((3, 1000)).astype(np.float32)
    got = resample_poly_device(torch.from_numpy(x), up, down).numpy()
    want = np.stack([resample_poly(r, up, down) for r in x]).astype(np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < ATOL


@pytest.mark.parametrize("up,down", CASES)
def test_matches_jax(up, down):
    x = np.random.default_rng(1).standard_normal((2, 777)).astype(np.float32)
    got = resample_poly_device(torch.from_numpy(x), up, down).numpy()
    want = np.asarray(jresample.resample_poly_device(jnp.asarray(x), up, down))
    assert got.shape == want.shape
    assert np.abs(got - want).max() < ATOL


def test_lengths_and_short_inputs():
    r = np.random.default_rng(2)
    for n in (1, 7, 400, 999, 16000):
        for up, down in ((4, 1), (3, 2), (160, 441)):
            assert resampled_length(n, up, down) == jresample.resampled_length(n, up, down)
            assert resampled_length(n, up, down) == len(resample_poly(np.zeros(n), up, down))
            if n < 16000:
                x = r.standard_normal((1, n)).astype(np.float32)
                got = resample_poly_device(torch.from_numpy(x), up, down).numpy()[0]
                assert np.abs(got - resample_poly(x[0], up, down)).max() < ATOL
    lens = np.array([1, 7, 400, 999], np.int32)
    got = resampled_lengths(torch.from_numpy(lens), 3, 2)
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(jresample.resampled_lengths(jnp.asarray(lens), 3, 2)).tolist()


def test_zero_padding_and_identity():
    x = np.zeros((2, 512), np.float32)
    x[0, :200] = np.random.default_rng(3).standard_normal(200)
    y = resample_poly_device(torch.from_numpy(x), 4).numpy()
    assert np.all(y[1] == 0.0)
    assert np.allclose(y[0, 200 * 4 + 50:], 0.0, atol=1e-7)
    t = torch.arange(12, dtype=torch.float32)[None]
    assert torch.equal(resample_poly_device(t, 1, 1), t)
    assert torch.equal(resample_poly_device(t, 3, 3), t)


@pytest.fixture(scope="module")
def wav4k(tmp_path_factory):
    """Four CirCor-like 4 kHz WAVs: tones and noise, 6-21 s."""
    d = tmp_path_factory.mktemp("wav4k")
    r = np.random.default_rng(3)
    paths = []
    for i, sec in enumerate((6.0, 10.0, 21.0, 12.5)):
        t = np.arange(int(sec * 4000)) / 4000
        x = 0.3 * np.sin(2 * np.pi * (60 + 15 * i) * t) + 0.02 * r.standard_normal(len(t))
        p = os.path.join(str(d), f"c{i}.wav")
        write_wav(p, x.astype(np.float32), 4000)
        paths.append(p)
    return paths


def test_device_upsample_matches_host_resampler(wav4k):
    """The extractor's prologue at source_sr=4000 (f32 wire) gives the
    waveform the 16 kHz host decode gives (scipy on the host), and keeps the
    FIR's ringing past each row's end, as the JAX prologue does."""
    ex = FeatureExtractor("operaCT", dim=768, batch_size=2, random_init=True,
                          wire_format="f32", source_sr=4000, device="cpu")
    x4, _ = load_wav(wav4k[0], sr=4000)
    x16, _ = load_wav(wav4k[0], sr=16000)
    w = torch.from_numpy(x4[None, :20000].copy())
    up, n = ex._prologue(w, torch.tensor([20000], dtype=torch.int32))
    assert int(n[0]) == 80000 and up.shape == (1, 80000)
    # the host resampled the whole file: compare away from the cut's edge
    assert np.abs(up[0, :79000].numpy() - x16[:79000]).max() < ATOL
    w = torch.zeros(2, 20000)
    w[:, :10000] = torch.from_numpy(x4[:10000].copy())
    up, n = ex._prologue(w, torch.tensor([10000, 20000], dtype=torch.int32))
    assert n.dtype == torch.int32 and n.tolist() == [40000, 80000]
    want = np.asarray(jresample.resample_poly_device(jnp.asarray(w.numpy()), 4))
    assert np.abs(up.numpy() - want).max() < ATOL
    assert torch.equal(up[0], up[1])  # the lengths mask nothing
    assert float(up[0, 40000:40040].abs().max()) > 0  # the ringing past row 0's end


@pytest.fixture(scope="module")
def source_sr_features(wav4k):
    """Features of the 4 kHz files, float32 with CirCor's zero padding (pad0,
    as cli.process runs it), on one set of weights: the JAX package's
    source_sr=4000 path, the port's, and the port's 16 kHz host path."""
    from heart_murmur_detection_tpu.extract.extract import FeatureExtractor as JFeatureExtractor
    from heart_murmur_detection_tpu_torch.extract import convert

    jex = JFeatureExtractor("operaCT", dim=768, input_sec=8, batch_size=2, random_init=True,
                            pad0=True, compute_dtype=jnp.float32, use_fused_htsat=False,
                            wire_format="f32", source_sr=4000)
    kw = dict(dim=768, input_sec=8, batch_size=2, random_init=True, pad0=True,
              compute_dtype=torch.float32, wire_format="f32", device="cpu")
    src, host = FeatureExtractor("operaCT", source_sr=4000, **kw), FeatureExtractor("operaCT", **kw)
    sd = convert.from_jax(jax.device_get(jex.variables))
    src.model.load_state_dict(sd)
    host.model.load_state_dict(sd)
    return {"jax": jex.extract_files(wav4k), "port": src.extract_files(wav4k),
            "host": host.extract_files(wav4k)}


def _cos(a, b):
    return np.sum(a * b, 1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_source_sr_extraction_matches_jax(source_sr_features):
    """The port's source_sr=4000 extraction against the JAX package's on the
    same weights and files: the same-rounding bar (cosine 0.99999 a clip)
    and tests/test_torch_extract.py's elementwise bar."""
    f = source_sr_features
    assert _cos(f["port"], f["jax"]).min() >= 0.99999, _cos(f["port"], f["jax"])
    np.testing.assert_allclose(f["port"], f["jax"], atol=2e-4, rtol=1e-3)


def test_source_sr_extraction_matches_host_path(source_sr_features):
    """source_sr=4000 (host decode, trim and pad at 4 kHz, device upsample)
    against the 16 kHz host path on the same weights. The FIR rings past
    each clip's end into the padding, where the host path has zeros, in
    both packages: held to the JAX package's own bar for source_sr
    (tests/test_wire.py), and each clip's cosine to what the JAX package's
    source_sr features read against the same host path."""
    f = source_sr_features
    cos, jcos = _cos(f["port"], f["host"]), _cos(f["jax"], f["host"])
    assert cos.min() > 0.999, cos
    np.testing.assert_allclose(cos, jcos, atol=1e-5)
