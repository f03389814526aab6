"""The port's host helpers and device DSP against the JAX package, on the
same numpy inputs: wire decode, mel frontend, bicubic resize, batch
packing, and the copied numpy/scipy helpers (WAV IO, filterbank, trim, pad,
whole-clip pipeline), which must give identical output."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.audio import dsp as jdsp
from heart_murmur_detection_tpu.audio import pad as jpad
from heart_murmur_detection_tpu.audio import pipelines as jpipe
from heart_murmur_detection_tpu.audio import reference_np as jref
from heart_murmur_detection_tpu.audio import wire as jwire
from heart_murmur_detection_tpu.utils import audio_io as jio
from heart_murmur_detection_tpu_torch.audio import dsp, pad, pipelines, wire
from heart_murmur_detection_tpu_torch.audio import reference_np as ref
from heart_murmur_detection_tpu_torch.utils import audio_io


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the test run shares the cores among its xdist
    workers, and torch's default of one spinning thread per core starves
    them (the port's tests took 4x the CPU time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def synth(n, sr=16000, seed=0, silence=0):
    r = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = 0.4 * np.sin(2 * np.pi * 60 * t) + 0.05 * r.standard_normal(n)
    x = x.astype(np.float32)
    if silence:  # quiet head and tail so trim has work to do
        x[:silence] *= 1e-5
        x[-silence:] *= 1e-5
    return x


@pytest.mark.parametrize("fmt", ["f32", "int16", "mulaw"])
def test_decode_device_matches_jax(fmt):
    x = synth(4096, seed=1).reshape(2, 2048)
    w = wire.encode_np(x, fmt)
    np.testing.assert_array_equal(w, jwire.encode_np(x, fmt))
    got = wire.decode_device(torch.from_numpy(w), fmt).numpy()
    want = np.asarray(jwire.decode_device(jnp.asarray(w), fmt))
    if fmt == "mulaw":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)


def test_mel_frontend_matches_jax():
    lens = [8 * 16000, 5 * 16000 + 123, 2 * 16000]
    clips = [synth(n, seed=i) for i, n in enumerate(lens)]
    batch, lengths = dsp.pad_batch(clips)
    got, nf = dsp.mel_frontend(torch.from_numpy(batch), torch.from_numpy(lengths))
    want, jnf = jdsp.mel_frontend(jnp.asarray(batch), jnp.asarray(lengths))
    np.testing.assert_array_equal(nf.numpy(), np.asarray(jnf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_mel_frontend_int16_wire_matches_jax():
    clips = [synth(3 * 16000, seed=4), synth(16000 + 77, seed=5)]
    batch, lengths = dsp.pad_batch(clips, dtype=np.int16)
    got, _ = dsp.mel_frontend(torch.from_numpy(batch), torch.from_numpy(lengths))
    want, _ = jdsp.mel_frontend(jnp.asarray(batch), jnp.asarray(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("src", [[251, 100], [1024, 3], [700, 1001]])
def test_resize_bicubic_time_matches_jax(src):
    r = np.random.default_rng(3)
    Tmax = max(max(src), 1024)
    x = r.standard_normal((len(src), Tmax, 8)).astype(np.float32)
    for i, s in enumerate(src):
        x[i, s:] = 0.0
    n = np.asarray(src, np.int32)
    got = dsp.resize_bicubic_time(torch.from_numpy(x), torch.from_numpy(n), 1024)
    want = jdsp.resize_bicubic_time(jnp.asarray(x), jnp.asarray(n), 1024)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # bf16 flow: bf16 weights and x, f32 accumulation, bf16 out
    got = dsp.resize_bicubic_time(
        torch.from_numpy(x), torch.from_numpy(n), 1024, compute_dtype=torch.bfloat16
    )
    want = jdsp.resize_bicubic_time(
        jnp.asarray(x), jnp.asarray(n), 1024, compute_dtype=jnp.bfloat16
    )
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=1e-2
    )


def test_resize_matches_torch_interpolate():
    """The banded form equals F.interpolate(bicubic, align_corners=True) on
    the valid rows (htsat.py:838-839)."""
    r = np.random.default_rng(8)
    x = r.standard_normal((1, 300, 4)).astype(np.float32)
    got = dsp.resize_bicubic_time(
        torch.from_numpy(np.pad(x, ((0, 0), (0, 724), (0, 0)))),
        torch.tensor([300], dtype=torch.int32), 1024,
    )
    want = torch.nn.functional.interpolate(
        torch.from_numpy(x)[:, None], (1024, 4), mode="bicubic", align_corners=True
    )[:, 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_pad_batch_identical(dtype):
    clips = [synth(n, seed=n) for n in (1000, 5000, 513)]
    for kw in ({}, {"max_len": 4000}, {"pad_to_multiple": 256}):
        got = dsp.pad_batch(clips, dtype=dtype, **kw)
        want = jdsp.pad_batch(clips, dtype=dtype, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_wav_io_identical(tmp_path):
    x = synth(16000 + 5, seed=2)
    p1, p2 = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    audio_io.write_wav(p1, x, 16000)
    jio.write_wav(p2, x, 16000)
    assert open(p1, "rb").read() == open(p2, "rb").read()
    for sr in (16000, 8000, None):
        got, gsr = audio_io.load_wav(p1, sr=sr)
        want, wsr = jio.load_wav(p1, sr=sr)
        assert gsr == wsr
        np.testing.assert_array_equal(got, want)


def test_reference_np_copies_identical():
    np.testing.assert_array_equal(ref.hann_periodic(1024), jref.hann_periodic(1024))
    np.testing.assert_array_equal(
        ref.mel_filterbank_slaney(16000, 1024, 64, 50, 8000),
        jref.mel_filterbank_slaney(16000, 1024, 64, 50, 8000),
    )
    y = synth(3 * 16000, seed=6, silence=4000)
    got, gse = ref.trim_heart(y, 16000)
    want, wse = jref.trim_heart(y, 16000)
    assert gse == wse and gse != (0, len(y))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("types", ["repeat", "zero"])
@pytest.mark.parametrize("n", [3 * 16000, 11 * 16000 + 7, 20 * 16000])
def test_split_pad_sample_identical(types, n):
    x = synth(n, seed=n % 97)
    got = pad.split_pad_sample(x, 8, 16000, types)
    want = jpad.split_pad_sample(x, 8, 16000, types)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("sec,types", [(5.0, "repeat"), (5.0, "zero"), (12.0, "repeat"), (40.0, "repeat")])
def test_get_entire_signal_identical(tmp_path, sec, types):
    p = str(tmp_path / "c.wav")
    audio_io.write_wav(p, synth(int(sec * 16000), seed=9, silence=3000), 16000)
    kw = dict(input_sec=8, pad=True, types=types, max_sec=32)
    got = pipelines.get_entire_signal(p, **kw)
    want = jpipe.get_entire_signal(p, **kw)
    np.testing.assert_array_equal(got, want)
    assert pipelines.get_entire_signal(p, input_sec=60) is None


@pytest.mark.parametrize("sec,trim_tail", [(5.0, False), (12.5, True), (12.5, False), (21.0, True)])
@pytest.mark.parametrize("spectrogram", [False, True])
def test_get_split_signal_identical(tmp_path, sec, trim_tail, spectrogram):
    """The fine-tuning cache's 8.18-s mel windows (spectrogram_pad8.npy)."""
    p = str(tmp_path / "c.wav")
    audio_io.write_wav(p, synth(int(sec * 16000), seed=11, silence=2000), 16000)
    kw = dict(input_sec=8.18, spectrogram=spectrogram, trim_tail=trim_tail)
    got = pipelines.get_split_signal(p, **kw)
    want = jpipe.get_split_signal(p, **kw)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("sec,trim_tail", [(4.0, False), (13.0, True), (13.0, False)])
@pytest.mark.parametrize("spectrogram", [False, True])
def test_get_split_signal_fbank_pad_identical(tmp_path, sec, trim_tail, spectrogram):
    """The fine-tuning cache's 10-s kaldi fbank windows (fbank_audiomae.npy)."""
    p = str(tmp_path / "c.wav")
    audio_io.write_wav(p, synth(int(sec * 16000), seed=12, silence=2000), 16000)
    kw = dict(input_sec=10, spectrogram=spectrogram, trim_tail=trim_tail)
    got = pipelines.get_split_signal_fbank_pad(p, **kw)
    want = jpipe.get_split_signal_fbank_pad(p, **kw)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_host_mel_and_fbank_copies_identical():
    y = synth(3 * 16000, seed=13)
    np.testing.assert_array_equal(ref.pre_process_audio_mel_t(y, 16000, f_max=8000),
                                  jref.pre_process_audio_mel_t(y, 16000, f_max=8000))
    np.testing.assert_array_equal(ref.kaldi_fbank(y - y.mean(), 16000),
                                  jref.kaldi_fbank(y - y.mean(), 16000))
    for n in (16000 * 10, 16000 * 10 + 1, 16000 * 25):
        assert pad.decide_droplast(n, 16000, 10) == jpad.decide_droplast(n, 16000, 10)
