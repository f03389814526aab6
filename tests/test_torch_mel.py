"""The port's fused log-mel frontend (ops/mel.py, CPU: the plain version of
the logmel kernel) against the JAX package's Pallas kernel K4 in interpret
mode, and the extractor's use_pallas_mel option against its default mel."""

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
