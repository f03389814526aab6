"""The port's HTS-AT tscam head and long-clip inference (models/htsat.py:
`tscam_conv`, `tscam_outputs`, `htsat_forward_long`) against the JAX
package on the same weights (a random JAX init carried over by
extract/convert.py::from_jax) and the same numpy inputs: the two cases of
tests/test_htsat_long.py on TINY_HTSAT, and the tscam outputs on TINY_HTSAT's
widths at a geometry where the head exists (the tiny config's final 2 x 2
map has fewer frequency rows than its freq_ratio, so it has no head in
either package)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.extract import convert as jconvert
from heart_murmur_detection_tpu.models.htsat import HTSAT as JHTSAT
from heart_murmur_detection_tpu.models.htsat import htsat_forward_long as j_forward_long
from heart_murmur_detection_tpu_torch.extract import convert
from heart_murmur_detection_tpu_torch.models.cola import Cola
from heart_murmur_detection_tpu_torch.models.htsat import (HTSAT, HTSATConfig, htsat_forward_long,
                                                           init_weights)
from heart_murmur_detection_tpu_torch.models.htsat_fused import htsat_apply_fused
from tests.test_pretrain import TINY_HTSAT

ATOL = 1e-5
# TINY_HTSAT's widths on a 128 x 64 image: final map 4 x 4, freq_ratio 2, so
# c_freq_bin 2 (the full config's) and 8 classes
TSCAM_TINY = dataclasses.replace(TINY_HTSAT, spec_size=128, mel_bins=64, enable_tscam=True)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the test run shares the cores among its xdist
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_config(jcfg) -> HTSATConfig:
    return HTSATConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(HTSATConfig)})


def pair(jcfg, T):
    """A random JAX HTSAT (jitted init) and the port's on its weights."""
    jm = JHTSAT(jcfg)
    v = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, T, jcfg.mel_bins))))
    sd = convert.from_jax({"params": {"encoder": v["params"]},
                           "batch_stats": {"encoder": v["batch_stats"]}})
    port = HTSAT(port_config(jcfg))
    port.load_state_dict({k[len(convert.HTSAT_PREFIX):]: t for k, t in sd.items()})
    return jm, v, port.eval()


@pytest.fixture(scope="module")
def tiny():
    return pair(TINY_HTSAT, 64)


@pytest.fixture(scope="module")
def tscam():
    return pair(TSCAM_TINY, 64)


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, err_msg=k)


def test_average_over_crops(tiny):
    """tests/test_htsat_long.py::test_average_over_crops: 2 crop lengths of
    one clip, crops every half crop; the port equals the JAX function and
    the mean of its own per-crop forwards."""
    jm, v, port = tiny
    target_T = TINY_HTSAT.spec_size * TINY_HTSAT.freq_ratio  # 256
    mel = np.random.default_rng(0).random((1, 2 * target_T, 16)).astype(np.float32)
    want = j_forward_long(jm, v, jnp.asarray(mel), crop_size=target_T, overlap=target_T // 2)
    got = htsat_forward_long(port, torch.from_numpy(mel), crop_size=target_T,
                             overlap=target_T // 2)
    assert port.tscam_conv is None and got["latent_output"].shape == (1, 128)
    _close(got, want)
    starts = np.arange(0, mel.shape[1] - target_T - 1, target_T // 2)
    assert len(starts) == 2
    manual = torch.stack([htsat_apply_fused(port, torch.from_numpy(mel[:, s : s + target_T]))
                          for s in starts]).mean(0)
    np.testing.assert_allclose(got["latent_output"].numpy(), manual.numpy(), atol=ATOL)


def test_short_clip_falls_through(tiny):
    """tests/test_htsat_long.py::test_short_clip_falls_through: no crop
    start, one plain forward."""
    jm, v, port = tiny
    mel = np.ones((1, 100, 16), np.float32)
    # jitted: the fall-through is one eager apply otherwise (~20 s of compiles)
    want = jax.jit(lambda v, x: j_forward_long(jm, v, x, crop_size=256, overlap=128))(
        v, jnp.asarray(mel))
    got = htsat_forward_long(port, torch.from_numpy(mel), crop_size=256, overlap=128)
    _close(got, want)
    np.testing.assert_array_equal(got["latent_output"].numpy(),
                                  htsat_apply_fused(port, torch.from_numpy(mel)).numpy())


def test_tscam_outputs_match_jax(tscam):
    """latent, framewise, clipwise outputs and logits of the JAX HTSAT on
    two clips, one with fewer valid frames than T."""
    jm, v, port = tscam
    r = np.random.default_rng(1)
    mel = r.random((2, 200, 64)).astype(np.float32)
    nf = np.array([200, 130], np.int32)
    want = jax.jit(jm.apply)(v, jnp.asarray(mel), jnp.asarray(nf))
    got = htsat_apply_fused(port, torch.from_numpy(mel), torch.from_numpy(nf), tscam=True)
    assert got["framewise_output"].shape == (2, 8 * 8 * 4, 8)  # 4 ST frames x 8 x stride 4
    _close(got, want)
    # the feature path is the same computation with or without the head
    np.testing.assert_array_equal(
        got["latent_output"].numpy(),
        htsat_apply_fused(port, torch.from_numpy(mel), torch.from_numpy(nf)).numpy())


def test_long_clip_with_tscam_matches_jax(tscam):
    """Every output averaged over 3 crops, the crops run 2 rows at a time."""
    jm, v, port = tscam
    target_T = TSCAM_TINY.spec_size * TSCAM_TINY.freq_ratio  # 256
    mel = np.random.default_rng(2).random((2, 2 * target_T + 60, 64)).astype(np.float32)
    want = j_forward_long(jm, v, jnp.asarray(mel), crop_size=target_T, overlap=target_T // 2)
    got = htsat_forward_long(port, torch.from_numpy(mel), crop_size=target_T,
                             overlap=target_T // 2, batch_size=2)
    assert set(got) == {"latent_output", "framewise_output", "clipwise_output",
                        "clipwise_logits"}
    _close(got, want)


def test_tscam_roundtrip_exact(tscam, monkeypatch):
    """from_jax carries tscam_conv, and the JAX convert_cola_htsat gives it
    back bit for bit (its block loop told the tiny depths)."""
    _, v, port = tscam
    monkeypatch.setattr(jconvert, "_HTSAT_DEPTHS", TSCAM_TINY.depths)
    sd = {convert.HTSAT_PREFIX + k: t.numpy() for k, t in port.state_dict().items()}
    back = jconvert.convert_cola_htsat(sd)["params"]["encoder"]["tscam_conv"]
    for leaf in ("kernel", "bias"):
        np.testing.assert_array_equal(back[leaf], np.asarray(v["params"]["tscam_conv"][leaf]))


def test_head_is_kept_by_states_without_it(tmp_path):
    """The full config carries the head (the JAX default); the seeded init
    draws it after every other weight, so those draw as without the head;
    a checkpoint without it leaves the model's head as built, and a
    training step never moves it (buffers, not parameters)."""
    with_head = Cola()
    without = Cola(HTSATConfig(enable_tscam=False))
    for m in (with_head, without):
        init_weights(m, torch.Generator().manual_seed(0))
    head = with_head.htsat.tscam_conv
    assert head.weight.shape == (527, 768, 2, 3) and float(head.weight.std()) > 0
    assert not any("tscam" in n for n, _ in with_head.named_parameters())
    sd = without.state_dict()
    for k, t in sd.items():
        assert torch.equal(with_head.state_dict()[k], t), k
    before = head.weight.clone()
    with_head.load_state_dict(sd)
    assert torch.equal(with_head.htsat.tscam_conv.weight, before)
    path = str(tmp_path / "old.ckpt")
    torch.save({"state_dict": sd}, path)
    loaded = convert.load_torch_ckpt(path, with_head)
    assert torch.equal(loaded.htsat.tscam_conv.weight, before)
