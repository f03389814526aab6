"""The VGGish baseline of the port (models/vggish.py: the host numpy
frontend, the network, extract_vgg_feature; extract/convert.py::
from_jax_vggish; extract_and_save's vggish branch and the CLIs) against the
JAX package on the same numpy inputs and the same jitted flax init: the
frontend bitwise, the network within 1e-4 (float32), each clip's mean
example embedding, the PCA postprocessor exactly, and the converter's round
trip exactly."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.models import vggish as jvggish
from heart_murmur_detection_tpu_torch.data.processors.common import extract_and_save
from heart_murmur_detection_tpu_torch.extract import convert
from heart_murmur_detection_tpu_torch.models import vggish
from heart_murmur_detection_tpu_torch.utils.audio_io import write_wav

RTOL = 1e-4  # the float32 class, relative to the largest magnitude


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flax_vggish():
    """A jitted flax init with its biases drawn away from zero (so the test
    reads them), and the port's VGGish on the same weights."""
    model = jvggish.VGGish()
    v = jax.device_get(jax.jit(lambda: model.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 96, 64))))())
    r = np.random.default_rng(1)
    params = {k: {"kernel": np.asarray(p["kernel"]),
                  "bias": r.normal(0, 0.05, np.shape(p["bias"])).astype(np.float32)}
              for k, p in v["params"].items()}
    v = {"params": params}
    port = vggish.VGGish()
    port.load_state_dict(convert.from_jax_vggish(v))
    return model, v, port.eval()


def _signal(n, seed):
    r = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * (150 + 40 * seed) * t)
            + 0.05 * r.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("n", [0, 399, 15599, 15760, 16000 * 3 + 123])
def test_frontend_bitwise_equal(n):
    """waveform_to_examples against the JAX function: the same bits, the
    same count of 0.96-s examples (none under 15760 samples)."""
    x = _signal(n, 2)
    got, want = vggish.waveform_to_examples(x), jvggish.waveform_to_examples(x)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(vggish._mel_matrix(), jvggish._mel_matrix())


def test_network_matches_flax(flax_vggish):
    """The (B, 96, 64) -> (B, 128) network, the NHWC flatten included."""
    model, v, port = flax_vggish
    x = np.concatenate([vggish.waveform_to_examples(_signal(16000 * 2, s)) for s in range(3)])
    want = np.asarray(jax.jit(model.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (6, 128)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, atol=RTOL * np.abs(want).max(), rtol=0)


def test_from_jax_vggish_round_trip_is_exact(flax_vggish):
    """from_jax_vggish and back (kernels transposed back): the same flax
    tree, leaf for leaf; the port's module loads it strictly."""
    _, v, _ = flax_vggish
    sd = convert.from_jax_vggish(v)
    back = {}
    for name in v["params"]:
        w = sd[name + ".weight"].numpy()
        back[name] = {"kernel": w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T,
                      "bias": sd[name + ".bias"].numpy()}
    assert set(back) == set(v["params"])
    for name, p in v["params"].items():
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back[name][leaf], np.asarray(p[leaf]),
                                          err_msg=f"{name}.{leaf}")
    vggish.VGGish().load_state_dict(sd)


def test_extract_vgg_feature_matches_jax(flax_vggish, tmp_path):
    """Each clip's mean example embedding (zeros for a clip shorter than one
    example), batches padded with zero examples, against the JAX
    extract_vgg_feature on the same weights."""
    _, v, port = flax_vggish
    paths = []
    for i, n in enumerate((16000 * 3 + 500, 8000, 16000 * 2)):
        p = str(tmp_path / f"c{i}.wav")
        write_wav(p, _signal(n, i + 5), 16000)
        paths.append(p)
    want = jvggish.extract_vgg_feature(paths, variables=v, batch_size=4)
    got = vggish.extract_vgg_feature(paths, model=port, batch_size=4, device="cpu")
    assert got.shape == want.shape == (3, 128)
    assert not got[1].any()
    np.testing.assert_allclose(got, want, atol=RTOL * np.abs(want).max(), rtol=0)


def test_postprocessor_matches_jax(tmp_path):
    """PCA whitening and 8-bit quantisation from a vggish_pca_params.npz:
    the JAX postprocessor's values exactly (the same numpy)."""
    r = np.random.default_rng(4)
    path = str(tmp_path / "vggish_pca_params.npz")
    np.savez(path, pca_eigen_vectors=r.standard_normal((128, 128)).astype(np.float32) * 0.1,
             pca_means=r.standard_normal((128, 1)).astype(np.float32))
    emb = r.standard_normal((5, 128)).astype(np.float32) * 3
    got = vggish.VGGishPostprocessor(path)(emb)
    want = jvggish.VGGishPostprocessor(path)(emb)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() <= 255 and (got == 0).any() and (got == 255).any()


def test_weights_are_required_and_seeded(tmp_path):
    """No model and no random_init: FileNotFoundError (the repository holds
    no VGGish checkpoint); random_init draws from the seed."""
    with pytest.raises(FileNotFoundError, match="VGGish weights"):
        vggish.extract_vgg_feature([], device="cpu")
    a = vggish.init_weights(vggish.VGGish(), torch.Generator().manual_seed(3)).state_dict()
    b = vggish.init_weights(vggish.VGGish(), torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    np.save(tmp_path / "sound_dir_loc.npy", np.array(["x.wav"]))
    with pytest.raises(FileNotFoundError, match="VGGish weights"):
        extract_and_save(str(tmp_path), "vggish", device="cpu")


def test_cli_process_vggish_then_linear_eval_on_cpu(tmp_path, monkeypatch):
    """cli.process pretrain=vggish random_init=True writes
    vggish_feature.npy; cli.linear_eval pretrain=vggish probes it."""
    from heart_murmur_detection_tpu_torch.cli import linear_eval, process

    for i in range(12):
        d = "training_data" if i < 6 else "validation_data" if i < 9 else "test_data"
        m = ("Present", "Absent", "Unknown")[i % 3]
        base = os.path.join(str(tmp_path), "datasets", "circor", d)
        os.makedirs(base, exist_ok=True)
        write_wav(os.path.join(base, f"{200 + i}_AV.wav"), _signal(int(4000 * (2 + 0.5 * i)), i),
                  4000)
        with open(os.path.join(base, f"{200 + i}.txt"), "w") as f:
            f.write(f"#Murmur: {m}\n#Outcome: Normal\n" + "".join(
                f"#Systolic murmur {k}: nan\n" for k in
                ("timing", "shape", "grading", "pitch", "quality")))
    monkeypatch.chdir(tmp_path)
    (out,) = process.main(["dataset=circor", "pretrain=vggish", "random_init=True", "device=cpu"])
    assert out == "feature/circor_eval/vggish_feature.npy"
    feats = np.load(out)
    assert feats.shape == (12, 128) and np.isfinite(feats).all()
    ((s0, s1),) = linear_eval.main(["task=circor_murmurs", "pretrain=vggish", "n_run=2",
                                    "device=cpu"])
    assert np.isfinite([s0, s1]).all()
