"""The port's HTS-AT / Cola (plain versions on the CPU) against the JAX
package on the same weights: a random JAX init carried over by
extract/convert.py::from_jax, at the full HTSATConfig() and at a narrow
config; plus the from_jax -> convert_cola_htsat round trip and reference
checkpoint loading."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.extract.convert import convert_cola_htsat
from heart_murmur_detection_tpu.models import htsat_fused as jhf
from heart_murmur_detection_tpu.models.cola import Cola as JCola
from heart_murmur_detection_tpu.models.cola import ColaConfig
from heart_murmur_detection_tpu.models.htsat import HTSAT as JHTSAT
from heart_murmur_detection_tpu.models.htsat import HTSATConfig as JHTSATConfig
from heart_murmur_detection_tpu_torch.extract import convert
from heart_murmur_detection_tpu_torch.models.cola import Cola
from heart_murmur_detection_tpu_torch.models.htsat import HTSAT, HTSATConfig
from heart_murmur_detection_tpu_torch.models.htsat_fused import htsat_apply_fused

@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the test run shares the cores among its xdist
    workers, and torch's default of one spinning thread per core starves
    them (the port's tests took 4x the CPU time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ATOL, RTOL = 2e-4, 1e-3


@pytest.fixture(scope="module")
def cola_pair():
    """A random JAX Cola(htsat) and the port's Cola on the same weights."""
    model = JCola(ColaConfig(encoder="htsat"))
    # jitted: one compile instead of an eager dispatch per op (~4x faster)
    v = jax.device_get(
        jax.jit(model.init)(jax.random.PRNGKey(0), (jnp.zeros((1, 64, 64)), jnp.zeros((1, 64, 64))))
    )
    port = Cola()
    port.load_state_dict(convert.from_jax(v))
    return model, v, port.eval()


@pytest.fixture(scope="module")
def mel():
    r = np.random.default_rng(0)
    return r.random((1, 251, 64)).astype(np.float32)


def _enc(v):
    return {"params": v["params"]["encoder"], "batch_stats": v["batch_stats"]["encoder"]}


def _leaves(tree, prefix=()):
    for k, x in tree.items():
        if isinstance(x, dict):
            yield from _leaves(x, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(x)


@pytest.mark.parametrize("dim", [768, 512])
def test_cola_extract_feature_matches_jax(cola_pair, mel, dim):
    model, v, port = cola_pair
    fn = jax.jit(lambda v, x: model.apply(v, x, dim, method=JCola.extract_feature))
    want = np.asarray(fn(v, jnp.asarray(mel)))
    got = port.extract_feature(torch.from_numpy(mel), dim).numpy()
    assert got.shape == (1, dim)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_htsat_apply_fused_matches_jax_interpret(cola_pair, mel):
    """f32: the port's fused forward vs the JAX fused forward with its
    Pallas kernels in interpret mode; frame counts shorter than T exercise
    the dynamic-length resize."""
    _, v, port = cola_pair
    nf = np.array([200], np.int32)
    want = np.asarray(
        jhf.htsat_apply_fused(_enc(v), jnp.asarray(mel), jnp.asarray(nf), interpret=True)
    )
    got = htsat_apply_fused(port.htsat, torch.from_numpy(mel), torch.from_numpy(nf)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_htsat_bf16_flow_tracks_jax_bf16_flow(cola_pair, mel):
    """bf16 flow on both sides (same rounding points): feature cosine."""
    _, v, port = cola_pair
    want = np.asarray(
        jhf.htsat_apply_fused(_enc(v), jnp.asarray(mel), mm_dtype=jnp.bfloat16, interpret=True)
    )
    got = port.htsat(torch.from_numpy(mel), mm_dtype=torch.bfloat16).numpy()
    cos = float(np.sum(got * want) / (np.linalg.norm(got) * np.linalg.norm(want)))
    assert cos >= 0.9999


NARROW = dict(embed_dim=24, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))


def test_narrow_htsat_matches_jax():
    jcfg, cfg = JHTSATConfig(**NARROW), HTSATConfig(**NARROW)
    jm = JHTSAT(jcfg)
    r = np.random.default_rng(1)
    mel = r.random((2, 130, 64)).astype(np.float32)
    nf = np.array([130, 90], np.int32)
    v = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(mel)))
    sd = convert.from_jax({"params": {"encoder": v["params"]}, "batch_stats": {"encoder": v["batch_stats"]}})
    port = HTSAT(cfg)
    port.load_state_dict({k[len(convert.HTSAT_PREFIX):]: t for k, t in sd.items()})
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(mel), jnp.asarray(nf))["latent_output"])
    want_fused = np.asarray(
        jhf.htsat_apply_fused(v, jnp.asarray(mel), jnp.asarray(nf), cfg=jcfg, interpret=True)
    )
    got = port(torch.from_numpy(mel), torch.from_numpy(nf)).numpy()
    assert got.shape == (2, 192)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, want_fused, atol=ATOL, rtol=RTOL)


def test_from_jax_roundtrip_exact(cola_pair):
    """from_jax -> the JAX package's convert_cola_htsat gives back the same
    flax tree (minus the tscam head, which the port does not carry): the
    port's keys are the reference's."""
    _, v, port = cola_pair
    sd = {k: t.numpy() for k, t in port.state_dict().items()}
    back = convert_cola_htsat(sd)
    want = dict(_leaves(v))
    got = dict(_leaves(back))
    want = {k: x for k, x in want.items() if "tscam_conv" not in k}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_load_torch_ckpt_reference_layout(cola_pair, tmp_path):
    """A reference-style Lightning checkpoint (extra tscam/head keys) loads by
    name; a checkpoint missing a key raises."""
    _, _, port = cola_pair
    sd = dict(port.state_dict())
    sd["encoder.encoder.htsat.tscam_conv.weight"] = torch.zeros(527, 768, 2, 3)
    sd["head.weight"] = torch.zeros(2, 2)
    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": sd, "epoch": 3}, path)
    fresh = convert.load_torch_ckpt(path, Cola())
    for k, t in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], t), k
    del sd["g.weight"]
    torch.save({"state_dict": sd}, path)
    with pytest.raises(KeyError):
        convert.load_torch_ckpt(path, Cola())


def test_prepared_cache_follows_weights(cola_pair, mel):
    """Loading new weights drops the kernel layout cache."""
    _, _, port = cola_pair
    m = Cola()
    m.load_state_dict(port.state_dict())
    a = m.extract_feature(torch.from_numpy(mel), 768)
    sd = m.state_dict()
    sd["encoder.encoder.htsat.layers.0.blocks.0.mlp.fc2.bias"] += 1.0
    m.load_state_dict(sd)
    b = m.extract_feature(torch.from_numpy(mel), 768)
    assert not torch.equal(a, b)
