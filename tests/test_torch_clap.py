"""The CLAP slice of the port (audio/dsp.py::logmel_frontend_general,
models/cnn14.py, models/clap.py, extract/convert.py's CLAP loaders,
extract_and_save's clap branches) against the JAX package on the same numpy
inputs and weights: the 44.1 kHz frontend at both fmax values, the Cnn14
(2022) and HTS-AT (2023) towers on their strict float32 graphs, the 2023
bf16 flow against the JAX fused forward with the TPU kernels K1-K3 in
interpret mode, the clip policy, batched extraction, the weight loaders
and the CLI. Both towers run at full width on 1-s clips."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heart_murmur_detection_tpu.models.htsat_fused as jhf
from heart_murmur_detection_tpu.audio import dsp as jdsp
from heart_murmur_detection_tpu.extract.convert import convert_clap_audio
from heart_murmur_detection_tpu.models import clap as jclap
from heart_murmur_detection_tpu.models.cnn14 import Cnn14 as JCnn14
from heart_murmur_detection_tpu_torch.audio import dsp
from heart_murmur_detection_tpu_torch.extract import convert
from heart_murmur_detection_tpu_torch.models import clap
from heart_murmur_detection_tpu_torch.utils.audio_io import load_wav, write_wav

# the strict float32 class of one tower (ROADMAP.md's precision classes)
ATOL, RTOL = 1e-4, 1e-4
# the bf16 flow on both sides: the kernel fidelity class
BF16_COS = 0.99999
N = 44160  # 1 s at 44.1 kHz, rounded up to whole hops
SR = 44100


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the test run shares the cores among its xdist
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cos(a, b) -> float:
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _wav(n=N, b=2, seed=0):
    r = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = 0.05 * r.standard_normal((b, n)) + 0.2 * np.sin(2 * np.pi * 440 * t)
    return x.astype(np.float32)


LENS = np.array([N, N - 7000], np.int32)  # the second row's tail is padding


def _tower(version):
    """(version, the JAX CLAPAudioEncoder's variables (numpy), a jitted apply
    returning (projected, backbone), the port's CLAPAudioEncoder on the same
    weights)."""
    model = jclap.CLAPAudioEncoder(jclap.CLAPConfig(version=version))
    v = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(1), jnp.zeros((1, N)),
                                           jnp.full((1,), N, jnp.int32)))
    apply = jax.jit(lambda v, w, l: model.apply(v, w, l, return_backbone=True))
    port = clap.CLAPAudioEncoder(clap.CLAPConfig(version=version))
    port.load_state_dict(convert.from_jax_clap(v, version))
    return version, v, apply, port.eval()


@pytest.fixture(scope="module")
def tower2022():
    return _tower("2022")


@pytest.fixture(scope="module")
def tower2023():
    return _tower("2023")


@pytest.fixture(params=["2022", "2023"])
def towers(request):
    return request.getfixturevalue(f"tower{request.param}")


# ---------------------------------------------------------------------------
# the frontend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmax", [14000.0, 8000.0])
def test_logmel_frontend_general_matches_jax(fmax):
    """torchlibrosa semantics at 44.1 kHz: reflect pad, hop 320, periodic
    Hann, slaney mels, 10 log10; frames past lengths // hop + 1 zero.
    Relative 1e-5 of the dB scale."""
    wav = _wav(seed=3)
    got, nf = dsp.logmel_frontend_general(torch.from_numpy(wav), torch.from_numpy(LENS), fmax=fmax)
    want, wnf = jdsp.logmel_frontend_general(jnp.asarray(wav), jnp.asarray(LENS), fmax=fmax)
    want = np.asarray(want)
    np.testing.assert_array_equal(nf.numpy(), np.asarray(wnf))
    assert got.shape == want.shape == (2, N // 320 + 1, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert (got[1, int(nf[1]):] == 0).all()


# ---------------------------------------------------------------------------
# the towers
# ---------------------------------------------------------------------------


def test_tower_f32_matches_jax(towers):
    """Each tower's strict float32 graph, projected and backbone embedding,
    a full clip and one ending early (Cnn14's masked pooling, HTS-AT's
    dynamic-length resize)."""
    version, v, apply, port = towers
    wav = _wav()
    want_p, want_e = (np.asarray(a) for a in apply(v, jnp.asarray(wav), jnp.asarray(LENS)))
    got_p, got_e = port(torch.from_numpy(wav), torch.from_numpy(LENS), return_backbone=True)
    assert got_p.shape == (2, 1024) and got_e.shape == (2, 2048 if version == "2022" else 768)
    np.testing.assert_allclose(got_e.numpy(), want_e, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_p.numpy(), want_p, atol=ATOL, rtol=RTOL)


def test_cnn14_at_5s_geometry_matches_jax(tower2022):
    """The Cnn14 alone at a 5-s clip's 690 frames (the pools floor 690 ->
    345 -> 172 -> 86 -> 43 -> 21 -> 10) with frame counts that put the
    pooled steps within T' and at 1 (test_tower_f32_matches_jax clips them
    at T')."""
    _, v, _, port = tower2022
    r = np.random.default_rng(5)
    logmel = (10 * r.standard_normal((2, 690, 64))).astype(np.float32)
    nf = np.array([300, 20], np.int32)
    sub = {"params": v["params"]["base"], "batch_stats": v["batch_stats"]["base"]}
    want = jax.jit(lambda x, n: JCnn14().apply(sub, x, n))(jnp.asarray(logmel), jnp.asarray(nf))
    got = port.base(torch.from_numpy(logmel), torch.from_numpy(nf))
    np.testing.assert_allclose(got["embedding"].numpy(), np.asarray(want["embedding"]),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["clipwise_output"].numpy(),
                               np.asarray(want["clipwise_output"]), atol=ATOL, rtol=RTOL)


def test_clap2023_bf16_flow_matches_jax_fused_interpret(tower2023):
    """The port's 2023 extraction flow (bf16, fast softmax; the kernels'
    plain versions on the CPU) against the JAX clap_audio_forward_fused with
    its Pallas swin kernels (K1-K3) in interpret mode, on one 1-s clip at
    full width: cosine >= 0.99999, the kernel fidelity class."""
    _, v, _, port = tower2023
    wav, lens = _wav(b=1, seed=7), np.array([N], np.int32)

    def interp(fn):
        return lambda *a, **k: fn(*a, **{**k, "interpret": True})

    with mock.patch.object(jhf, "fused_swin_block", interp(jhf.fused_swin_block)), \
            mock.patch.object(jhf, "fused_swin_pair", interp(jhf.fused_swin_pair)), \
            mock.patch.object(jhf, "fused_swin_block_split", interp(jhf.fused_swin_block_split)):
        want = np.asarray(jax.jit(lambda v, w, l: jclap.clap_audio_forward_fused(
            v, w, l, jclap.CLAPConfig(version="2023"), fast_softmax=True))(
                v, jnp.asarray(wav), jnp.asarray(lens)))
    got = clap.clap_audio_forward_fused(port, torch.from_numpy(wav), torch.from_numpy(lens),
                                        torch.bfloat16, fast_softmax=True).numpy()
    assert got.shape == (1, 1024) and np.isfinite(got).all()
    assert _cos(got, want) >= BF16_COS
    with pytest.raises(ValueError):
        clap.clap_audio_forward_fused(clap.CLAPAudioEncoder(clap.CLAPConfig(version="2022")),
                                      torch.from_numpy(wav), torch.from_numpy(lens))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=()):
    for k, x in tree.items():
        if isinstance(x, dict):
            yield from _leaves(x, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(x)


def _msclap_sd(port, v, version, prefix):
    """A synthetic msclap state_dict: the port's weights under `prefix`,
    plus keys the port does not hold (the text tower, the frontend's
    buffers and, for 2023, the tscam head the JAX tower applies)."""
    sd = {prefix + k: t.clone() for k, t in port.state_dict().items()}
    sd["caption_encoder.base.embeddings.word_embeddings.weight"] = torch.zeros(3, 4)
    base = prefix + ("base.htsat." if version == "2023" else "base.")
    sd[base + "spectrogram_extractor.stft.conv_real.weight"] = torch.zeros(513, 1, 1024)
    if version == "2023":
        k = np.asarray(v["params"]["base"]["tscam_conv"]["kernel"])
        sd[base + "tscam_conv.weight"] = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
        sd[base + "tscam_conv.bias"] = torch.from_numpy(
            np.asarray(v["params"]["base"]["tscam_conv"]["bias"]).copy())
    return sd


def test_from_jax_clap_roundtrip_exact(towers):
    """from_jax_clap -> the JAX package's convert_clap_audio gives back the
    same flax tree (minus the tscam head, which the port does not carry)."""
    version, v, _, port = towers
    sd = {"audio_encoder." + k: t.numpy() for k, t in port.state_dict().items()}
    back = convert_clap_audio(sd, version)
    want = {k: x for k, x in _leaves(v) if "tscam_conv" not in k}
    got = dict(_leaves(back))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


@pytest.mark.parametrize("version,prefix", [("2022", "audio_encoder."),
                                            ("2023", "clap.audio_encoder."),
                                            ("2023", "model.audio_encoder.")])
def test_load_clap_ckpt_msclap_layout(request, tmp_path, version, prefix):
    """A synthetic msclap checkpoint (file) loads by name into a fresh
    tower, which then gives the features the JAX package gives on
    convert_clap_audio of the same state_dict; each prefix the JAX
    converter accepts."""
    _, v, apply, port = request.getfixturevalue(f"tower{version}")
    sd = _msclap_sd(port, v, version, prefix)
    for k in sd:  # weights of its own, so that nothing is left from `port`
        if k.endswith("weight") and "projection" in k:
            sd[k] = sd[k] * 1.5
    path = str(tmp_path / "clap.pth")
    torch.save({"model": sd}, path)
    fresh = convert.load_clap_ckpt(path, version)
    jv = convert_clap_audio({k: t.numpy() for k, t in sd.items()}, version)
    wav = _wav(seed=9)
    want = np.asarray(apply(jv, jnp.asarray(wav), jnp.asarray(LENS))[0])
    got = fresh(torch.from_numpy(wav), torch.from_numpy(LENS)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_load_clap_ckpt_refuses_bad_checkpoints(towers):
    version, v, _, port = towers
    sd = _msclap_sd(port, v, version, "audio_encoder.")
    with pytest.raises(KeyError, match="no audio_encoder"):
        convert.load_clap_ckpt({"text." + k: t for k, t in sd.items()}, version)
    del sd["audio_encoder.projection.linear2.weight"]
    with pytest.raises(KeyError, match="lacks"):
        convert.load_clap_ckpt(sd, version)


# ---------------------------------------------------------------------------
# clips and extraction
# ---------------------------------------------------------------------------


def _clip_files(tmp_path, secs=(0.7, 9.0, 2.2, 12.5), sr=22050):
    """WAVs of the given lengths at a rate the loader resamples from."""
    r = np.random.default_rng(11)
    paths = []
    for i, sec in enumerate(secs):
        p = str(tmp_path / f"c{i}.wav")
        write_wav(p, (0.1 * r.standard_normal(int(sec * sr))).astype(np.float32), sr)
        paths.append(p)
    return paths


def test_load_clap_clip_tile_and_crop(tmp_path):
    """Short clips tiled, long ones cropped at a start drawn from the shared
    rng only for them: the same samples as the JAX load_clap_clip, file by
    file, with one rng each over the same files."""
    paths = _clip_files(tmp_path)
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    for p in paths:
        got = clap.load_clap_clip(p, 5.0, rng=r1)
        want = jclap.load_clap_clip(p, 5.0, rng=r2)
        assert got.shape == (5 * SR,) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    short = clap.load_clap_clip(paths[0], 5.0)
    n0 = len(load_wav(paths[0], SR)[0])
    np.testing.assert_array_equal(short[:n0], short[n0: 2 * n0])


def test_extract_clap_feature_batching(tower2023, tmp_path):
    """Batches of 2 over 3 files (the last filled with copies of its first
    clip), one rng over the files in order, lengths the stacked width: the
    JAX extract_clap_feature's features on the same weights, f32 graph (the
    2023 tower, the cheaper of the two at 7 s on the CPU)."""
    version, v, _, port = tower2023
    paths = _clip_files(tmp_path, secs=(3.0, 9.5, 11.0))
    got = clap.extract_clap_feature(paths, version, model=port, batch_size=2, device="cpu")
    want = jclap.extract_clap_feature(paths, version, variables=v, batch_size=2, use_fused=False)
    assert got.shape == (3, 1024)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_cli_process_then_linear_eval_clap2023_on_cpu(tmp_path, monkeypatch):
    """pretrain=clap2023 end to end on the CPU: cli.process writes
    clap2023_feature.npy under the JAX name, cli.linear_eval probes it (2
    seeds here), and the JAX package's probe reads the same file."""
    from heart_murmur_detection_tpu.train.linear_eval import linear_evaluation_heart
    from heart_murmur_detection_tpu_torch.cli import linear_eval, process

    from .test_torch_process import _circor_corpus

    _circor_corpus(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    (out,) = process.main(["dataset=circor", "pretrain=clap2023", "random_init=True",
                           "device=cpu"])
    assert out == "feature/circor_eval/clap2023_feature.npy"
    feats = np.load(out)
    assert feats.shape == (12, 1024) and np.isfinite(feats).all()
    ((s0, s1),) = linear_eval.main(["task=circor_murmurs", "pretrain=clap2023", "n_run=2",
                                    "device=cpu"])
    assert np.isfinite([s0, s1]).all() and 0 <= min(s0, s1) <= max(s0, s1) <= 1
    res = linear_evaluation_heart(seed=0, use_feature="clap2023", loss="weighted",
                                  feature_dir="feature/circor_eval/", labels_filename="murmurs.npy")
    assert np.isfinite(res.test_auc)


def test_clap_without_weights_or_card_raises():
    with pytest.raises(FileNotFoundError, match="msclap"):
        clap.extract_clap_feature([], "2023", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            clap.extract_clap_feature([], "2023", random_init=True, device="cuda")
