"""The port's fused log-mel frontend (ops/mel.py, CPU: the plain version of
the logmel kernel) against the JAX package's Pallas kernel K4 in interpret
mode, and the extractor's use_pallas_mel option against its default mel.

The CUDA kernel (csrc/logmel.cu) runs only on a card; its algorithm is held
here through _kernel_model, a float32 torch model of its schedule (the
Stockham radix-8 FFT of the even / odd samples, the real-FFT split step,
the power, the sparse mel sums in ascending bin order) built on the same
host tables, against the TPU kernel and against a float64 evaluation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.audio import dsp as jdsp
from heart_murmur_detection_tpu.ops.pallas_mel import fused_logmel as jfused_logmel
from heart_murmur_detection_tpu.ops.pallas_mel import mel_frontend_pallas
from heart_murmur_detection_tpu_torch.audio import dsp
from heart_murmur_detection_tpu_torch.extract.extract import FeatureExtractor
from heart_murmur_detection_tpu_torch.ops import mel


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(lens, seed, max_len=None):
    r = np.random.default_rng(seed)
    clips = [r.standard_normal(n).astype(np.float32) for n in lens]
    return jdsp.pad_batch(clips, max_len=max_len)


def test_matches_pallas_frontend():
    """tests/test_pallas_mel.py's inputs and bar (atol 3e-4 on the normalised
    mel, frame counts exact)."""
    wav, lengths = _batch([5 * 16000, 3 * 16000 + 512], 0)
    want, nf_w = mel_frontend_pallas(jnp.asarray(wav), jnp.asarray(lengths), interpret=True)
    got, nf_g = mel.mel_frontend_fused(torch.from_numpy(wav), torch.from_numpy(lengths))
    np.testing.assert_array_equal(nf_g.numpy(), np.asarray(nf_w))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-4)


def test_masking():
    """tests/test_pallas_mel.py's masking case: frames past a clip are zero,
    the rest in [0, 1]."""
    wav, lengths = _batch([2 * 16000], 1, max_len=8 * 16000)
    got, nf = mel.mel_frontend_fused(torch.from_numpy(wav), torch.from_numpy(lengths))
    g = got.numpy()
    assert np.abs(g[0, int(nf[0]):]).max() == 0.0
    assert 0.0 <= g.min() and g.max() <= 1.0


def test_logmel_ref_matches_pallas_kernel():
    """Before the normalisation: log10 mel power within 1e-4 (log10 units)
    of the TPU kernel's interpret-mode output, int16 PCM input included."""
    wav, _ = _batch([4 * 16000 + 1000, 16000], 2)
    want = np.asarray(jfused_logmel(jnp.asarray(wav), interpret=True))
    got = mel.fused_logmel_ref(torch.from_numpy(wav))
    assert got.shape == want.shape == (2, wav.shape[1] // 512 + 1, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    pcm, lengths = jdsp.pad_batch([wav[0, :8000]], dtype=np.int16)
    a, _ = mel.mel_frontend_fused(torch.from_numpy(pcm), torch.from_numpy(lengths))
    b, _ = mel_frontend_pallas(jnp.asarray(pcm), jnp.asarray(lengths), interpret=True)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-4)


def test_kernel_layout_drops_only_zero_bins():
    """The kernel computes bins 0..511: the float32 filterbank weights bin 512
    by zero, so the dense product and the kernel's differ by zero terms."""
    fb = dsp._mel_fb(16000, 1024, 64, 50.0, 8000.0)
    assert fb.shape == (513, 64) and fb.dtype == np.float32
    assert np.all(fb[mel.KERNEL_BINS:] == 0) and np.any(fb[mel.KERNEL_BINS - 1] != 0)
    with pytest.raises(ValueError, match="weights a bin above"):
        mel._device_bases(torch.device("cpu"), 8000, 50.0, 8000.0)  # filters past Nyquist


def test_mel_table_rebuilds_the_filterbank():
    """The kernel's compact filterbank holds every nonzero of dsp._mel_fb,
    in ascending bin order, exactly: 990 weights over bins 4..511, at most
    45 a mel, each bin in at most two mels."""
    fb = dsp._mel_fb(16000, 1024, 64, 50.0, 8000.0)
    idx, w = mel.mel_table(16000, 50.0, 8000.0)
    first, off = idx[:64], idx[64:]
    assert idx.dtype == np.int32 and w.dtype == np.float32 and off[0] == 0
    dense = np.zeros_like(fb)
    for m in range(64):
        dense[first[m]:first[m] + off[m + 1] - off[m], m] = w[off[m]:off[m + 1]]
    np.testing.assert_array_equal(dense, fb)
    assert w.size == np.count_nonzero(fb) == 990 and np.all(w != 0)
    assert first.min() == 4 and (first + np.diff(off)).max() == mel.KERNEL_BINS
    assert np.diff(off).max() == 45 and np.count_nonzero(fb, axis=1).max() <= 2


def test_fft_tables_within_an_ulp():
    """The float32 window and twiddles are the float64 values cast once:
    within one float32 ulp of them."""
    t = mel.fft_tables()
    r = np.arange(1, 8)[:, None]
    tw = np.concatenate([np.exp(-2j * np.pi * r * np.arange(8)[None] / 64).ravel(),
                         np.exp(-2j * np.pi * r * np.arange(64)[None] / 512).ravel(),
                         np.exp(-2j * np.pi * np.arange(512) / 1024)])
    want = np.concatenate([0.5 - 0.5 * np.cos(2 * np.pi * np.arange(1024) / 1024),
                           np.stack([tw.real, tw.imag], -1).ravel()])
    assert t.dtype == np.float32 and t.shape == want.shape == (1024 + 2 * 1016,)
    ulp = np.spacing(np.abs(t)).astype(np.float64)
    assert np.all(np.abs(t.astype(np.float64) - want) <= ulp)
    np.testing.assert_array_equal(t[:1024], dsp.ref.hann_periodic(1024).astype(np.float32))


def test_fft_exchange_swizzle_is_conflict_free():
    """csrc/logmel.cu's per-warp exchange buffer: under the swizzle
    i ^ ((i >> 3) & 15) the float2 reads z[j + 64 r] and the pass-1 / pass-2
    writes 8 j + r and 64 (j / 8) + j % 8 + 8 r hit 16 distinct 8-byte bank
    pairs in each half-warp (lanes j = base .. base + 15), for every r, and
    the swizzle permutes 0..511."""
    swz = lambda i: i ^ ((i >> 3) & 15)  # noqa: E731
    assert sorted(swz(i) for i in range(512)) == list(range(512))
    for base in (0, 16, 32, 48):
        js = range(base, base + 16)
        for r in range(8):
            for idx in ([j + 64 * r for j in js], [8 * j + r for j in js],
                        [64 * (j // 8) + j % 8 + 8 * r for j in js]):
                assert len({swz(i) % 16 for i in idx}) == 16


def _fft8(re, im):
    """8-point DFTs along a list of 8 tensors, as the kernel's fft8: a
    radix-2 step on (r, r + 4), the odd half times W_8^r, two 4-point DFTs."""
    s = float(np.float32(np.sqrt(0.5)))
    ar, ai = [re[r] + re[r + 4] for r in range(4)], [im[r] + im[r + 4] for r in range(4)]
    br, bi = [re[r] - re[r + 4] for r in range(4)], [im[r] - im[r + 4] for r in range(4)]
    br[1], bi[1] = (br[1] + bi[1]) * s, (bi[1] - br[1]) * s
    br[2], bi[2] = bi[2], -br[2]
    br[3], bi[3] = (bi[3] - br[3]) * s, -(br[3] + bi[3]) * s

    def fft4(ur, ui):
        s0r, s0i, d0r, d0i = ur[0] + ur[2], ui[0] + ui[2], ur[0] - ur[2], ui[0] - ui[2]
        s1r, s1i, d1r, d1i = ur[1] + ur[3], ui[1] + ui[3], ui[1] - ui[3], -(ur[1] - ur[3])
        return [s0r + s1r, d0r + d1r, s0r - s1r, d0r - d1r], [s0i + s1i, d0i + d1i,
                                                              s0i - s1i, d0i - d1i]

    (er, ei), (orr, oi) = fft4(ar, ai), fft4(br, bi)
    return [v for k in range(4) for v in (er[k], orr[k])], [v for k in range(4) for v in (ei[k], oi[k])]


def _kernel_model(wav: torch.Tensor) -> torch.Tensor:
    """The logmel kernel's schedule in float32 torch, on its host tables: a
    test helper, never on the main path."""
    B, N = wav.shape
    T = N // 512 + 1
    tables = torch.from_numpy(mel.fft_tables())
    tw = tables[1024:].view(-1, 2)
    idx, w = mel.mel_table(16000, 50.0, 8000.0)
    x = torch.nn.functional.pad(wav, (512, 512))
    frames = torch.stack([x[:, t * 512:t * 512 + 1024] for t in range(T)], 1).reshape(-1, 1024)
    frames = frames * tables[:1024]
    zr, zi = frames[:, 0::2], frames[:, 1::2]  # z[n] = x[2n] + i x[2n+1]
    j = torch.arange(64)
    # Stockham radix 8 x 8 x 8: read z[j + 64 r], twiddle W_(8 Ns)^(r (j % Ns)),
    # radix 8, write at (j // Ns) 8 Ns + j % Ns + r Ns
    for Ns, t in ((1, None), (8, tw[:56].view(7, 8, 2)), (64, tw[56:504].view(7, 64, 2))):
        vr = [zr[:, r * 64:(r + 1) * 64] for r in range(8)]
        vi = [zi[:, r * 64:(r + 1) * 64] for r in range(8)]
        for r in range(1, 8) if t is not None else ():
            wr, wi = t[r - 1][j % Ns].unbind(-1)
            vr[r], vi[r] = vr[r] * wr - vi[r] * wi, vr[r] * wi + vi[r] * wr
        outr, outi = _fft8(vr, vi)
        zr, zi = torch.empty_like(zr), torch.empty_like(zi)
        for r in range(8):
            dst = (j // Ns) * Ns * 8 + j % Ns + r * Ns
            zr[:, dst], zi[:, dst] = outr[r], outi[r]
    # split step: X[k] = E[k] + W_1024^k O[k], E and O from Z[k], Z*[512 - k]
    mirror = (512 - torch.arange(512)) % 512
    mr, mi = zr[:, mirror], zi[:, mirror]
    er, ei, orr, oi = 0.5 * (zr + mr), 0.5 * (zi - mi), 0.5 * (zi + mi), 0.5 * (mr - zr)
    wr, wi = tw[504:].unbind(-1)
    re, im = er + (wr * orr - wi * oi), ei + (wr * oi + wi * orr)
    power = re * re + im * im
    first, off = idx[:64], idx[64:]
    out = torch.zeros(power.shape[0], 64)
    for m in range(64):
        for i in range(off[m + 1] - off[m]):  # ascending bins
            out[:, m] = out[:, m] + power[:, first[m] + i] * float(w[off[m] + i])
    return torch.log10(torch.clamp(out, min=1e-10)).reshape(B, T, 64)


def test_kernel_model_matches_pallas_kernel():
    """The kernel's algorithm against the TPU kernel in interpret mode, at
    test_logmel_ref_matches_pallas_kernel's inputs and bar (atol 1e-4,
    log10 units), and a clip of one hop (two frames)."""
    wav, _ = _batch([4 * 16000 + 1000, 16000], 2)
    want = np.asarray(jfused_logmel(jnp.asarray(wav), interpret=True))
    got = _kernel_model(torch.from_numpy(wav))
    assert got.shape == want.shape == (2, wav.shape[1] // 512 + 1, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    short = np.random.default_rng(3).standard_normal((1, 512)).astype(np.float32)
    np.testing.assert_allclose(_kernel_model(torch.from_numpy(short)).numpy(),
                               np.asarray(jfused_logmel(jnp.asarray(short), interpret=True)),
                               atol=1e-4)


def test_kernel_model_float32_error():
    """Against a float64 evaluation of the function (the plain version on
    the same float32 bases, exact in float64), on a 1e-3 tone plus 1e-5
    noise (bench/logmel_time.py::precision's input, 3 s): the model's max
    error within the card's bar, 4x the plain float32 version's
    (LOGMEL_F64_RATIO); a TF32 or bf16 pass would miss it by orders of
    magnitude on the bins far from the tone."""
    r = np.random.default_rng(1)
    n = 3 * 16000 + 512 - 3 * 16000 % 512
    t = np.arange(n) / 16000
    w = (1e-3 * np.sin(2 * np.pi * 440 * t)[None] + 1e-5 * r.standard_normal((2, n)))
    wav = torch.from_numpy(w.astype(np.float32))
    ref64 = mel.fused_logmel_ref(wav.double())
    model = (_kernel_model(wav).double() - ref64).abs().max()
    plain = (mel.fused_logmel_ref(wav).double() - ref64).abs().max()
    assert model <= 4 * plain, (float(model), float(plain))
    assert model < 1e-4


def test_cpu_tensor_runs_the_plain_version():
    wav = torch.from_numpy(_batch([16000], 3)[0])
    before = mel.launch_counts()
    assert torch.equal(mel.fused_logmel(wav), mel.fused_logmel_ref(wav))
    assert mel.launch_counts() == before
    with pytest.raises(ValueError, match="multiple of the hop"):
        mel.fused_logmel(wav[:, :1000])


def test_extractor_use_pallas_mel():
    """FeatureExtractor(use_pallas_mel=True) routes operaCT's mel through
    mel_frontend_fused: the mel agrees with the default frontend, and the
    features of a ragged batch with them."""
    kw = dict(dim=768, batch_size=2, random_init=True, compute_dtype=torch.float32, device="cpu")
    fused = FeatureExtractor("operaCT", use_pallas_mel=True, **kw)
    default = FeatureExtractor("operaCT", **kw)
    default.model.load_state_dict(fused.model.state_dict())
    wav, lengths = _batch([8 * 16000, 9 * 16000 + 300], 4)
    w, n = torch.from_numpy(wav), torch.from_numpy(lengths)
    (a, na), (b, nb) = fused._mel(w, n), default._mel(w, n)
    assert torch.equal(na, nb)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-4)
    clips = [wav[0], wav[1, : lengths[1]]]
    fa, fb = fused.extract_waveforms(clips), default.extract_waveforms(clips)
    cos = np.sum(fa * fb, 1) / (np.linalg.norm(fa, axis=1) * np.linalg.norm(fb, axis=1))
    assert cos.min() >= 0.99999, cos
