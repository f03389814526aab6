"""The OPERA-CE slice of the port (models/bn.py, models/efficientnet.py, the
EfficientNet branch of models/cola.py, extract/convert.py's EfficientNet
loaders, FeatureExtractor("operaCE"), the COLA step of
pretrain/cola_training.py with the EfficientNet) against the JAX package on
the same numpy inputs and the same jitted JAX init, at full width (the
EfficientNet-B0 is 4.9 M parameters): the features at dims 1280 and 512 with
valid-frame masks on ragged lengths, the independent torch oracle of
tests/torch_mini/efficientnet_eval.py by name, one train-mode pair forward
(outputs and the 49 BatchNorms' running statistics against flax's
mutable batch_stats), a float32 COLA step's loss and gradient leaves, the
converter's round trip, drop-connect, the bf16 flow's casts, and the
config-default CLIs (cli.process, cli.linear_eval, cli.pretrain) on the CPU.

At a random init the EfficientNet's eval output hardly depends on its
input: every non-skip block scales its input by about 1/8 (two SiLUs near 0
and the SE gate at 1/2) and the BatchNorms' unit running variances do not
undo it, so the features are the running means' offsets to 1e-8. The eval
tests therefore calibrate the running statistics on a batch of inputs first
(calibrate_bn: one train-mode pass with momentum 0, i.e. the batch
statistics), on the port, and carry them to the JAX package with its own
converter (convert_cola_efficientnet, exact both ways). Drop-connect and
dropout are off (p = 0) wherever the two packages are compared."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heart_murmur_detection_tpu.extract.registry as jregistry
from heart_murmur_detection_tpu.extract import convert as jconvert
from heart_murmur_detection_tpu.extract.extract import FeatureExtractor as JFeatureExtractor
from heart_murmur_detection_tpu.models.cola import Cola as JCola
from heart_murmur_detection_tpu.models.cola import ColaConfig
from heart_murmur_detection_tpu.models.cola import cola_loss as jcola_loss
from heart_murmur_detection_tpu_torch.extract import convert
from heart_murmur_detection_tpu_torch.extract.extract import FeatureExtractor
from heart_murmur_detection_tpu_torch.models import bn as bn_mod
from heart_murmur_detection_tpu_torch.models import efficientnet as eff
from heart_murmur_detection_tpu_torch.models.cola import Cola
from heart_murmur_detection_tpu_torch.pretrain import cola_training as ct
from heart_murmur_detection_tpu_torch.utils.audio_io import write_wav
from tests.torch_mini.efficientnet_eval import ColaCEEval

FEAT_RTOL = 1e-4  # features, relative to their largest magnitude (float32 class)
STATS_TOL = 1e-5  # BatchNorm running statistics
# Train-mode outputs. flax normalises with the fast variance mean(x^2) -
# mean(x)^2 over a batch of 4 (the last maps are 3 x 2 a sample), which loses
# digits in float32 on either side: against the same forward in float64 the
# JAX package's outputs are off by 2.4e-5 and the port's by 1.4e-5 here, so
# the port is held to 5e-5 of flax and to no more than flax's own distance
# from float64.
TRAIN_OUT_TOL = 5e-5
TOL = 2e-4  # gradient leaves, relative to the leaf's scale (ROADMAP precision classes)
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _perturb_stats(tree, r):
    for k, x in tree.items():
        if isinstance(x, dict):
            _perturb_stats(x, r)
        elif k == "mean":
            tree[k] = r.normal(0, 0.2, np.shape(x)).astype(np.float32)
        elif k == "var":
            tree[k] = r.uniform(0.6, 1.5, np.shape(x)).astype(np.float32)


def calibrate_bn(encoder, x: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics of a ColaEfficientNetEncoder
    to the statistics of batch x (one train-mode pass at momentum 0)."""
    stats = {}
    keep, eff.BN_MOMENTUM = eff.BN_MOMENTUM, 0.0
    try:
        with torch.no_grad():
            encoder(x, stats=stats)
    finally:
        eff.BN_MOMENTUM = keep
    bn_mod.commit(stats)


def _jax_init(p=0.1, seed=0):
    model = JCola(ColaConfig(encoder="efficientnet", p=p))
    z = jnp.zeros((1, 64, 64))
    v = jax.tree.map(np.asarray, jax.device_get(
        jax.jit(lambda: model.init(jax.random.PRNGKey(seed), (z, z)))()))
    _perturb_stats(v["batch_stats"], np.random.default_rng(seed + 1))
    return v


@pytest.fixture(scope="module")
def variables():
    """A JAX init whose running statistics are calibrated on a (6, 251, 64)
    batch (through the port, back by the JAX converter)."""
    v = _jax_init()
    port = _port(v)
    calibrate_bn(port.encoder, torch.from_numpy(
        np.random.default_rng(9).standard_normal((6, 251, 64)).astype(np.float32)))
    return jax.tree.map(np.asarray, jconvert.convert_cola_efficientnet(
        {k: t.numpy() for k, t in port.state_dict().items()}))


def _port(v, p=0.1):
    port = Cola(encoder="efficientnet", p=p)
    port.load_state_dict(convert.from_jax_efficientnet(v))
    return port


def _named(model, stats):
    """A models/bn.py stats dict keyed by each BatchNorm's name in model."""
    names = {m: n for n, m in model.named_modules()}
    return {names[bn]: v for bn, v in stats.items()}


def _close(got, want, rtol, tag=""):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= rtol * max(1.0, float(np.abs(want).max())), (tag, err)


@pytest.mark.parametrize("dim", [1280, 512])
def test_extract_feature_matches_jax_with_ragged_masks(variables, dim):
    """Cola.extract_feature with frame counts (the masked global pool over
    ceil((n - 2) / 32) rows): three clips of 251, 180 and 97 frames in one
    padded batch."""
    model = JCola(ColaConfig(encoder="efficientnet"))
    r = np.random.default_rng(2)
    mel = r.standard_normal((3, 251, 64)).astype(np.float32)
    nf = np.array([251, 180, 97], np.int32)
    want = np.asarray(jax.jit(lambda v, m, n: model.apply(
        v, m, dim, n, method=JCola.extract_feature))(variables, mel, nf))
    got = _port(variables).eval().extract_feature(torch.from_numpy(mel), dim,
                                                  torch.from_numpy(nf)).numpy()
    assert got.shape == want.shape == (3, dim)
    _close(got, want, FEAT_RTOL, dim)
    # the clips differ, and the mask matters: the third clip's feature is
    # not its unmasked pool
    assert np.abs(got[0] - got[1]).max() > 0.1 * np.abs(got).max()
    full = _port(variables).eval().extract_feature(torch.from_numpy(mel[2:]), dim).numpy()
    assert np.abs(full - got[2:]).max() > 0.1 * np.abs(got).max()


@pytest.mark.parametrize("dim", [1280, 512])
def test_matches_the_torch_mini_oracle_by_name(dim):
    """The independent efficientnet-pytorch-layout oracle's state_dict loads
    into the port by name (load_cola_efficientnet_ckpt) and gives the same
    features (no frame counts: the oracle pools globally)."""
    torch.manual_seed(0)
    oracle = ColaCEEval().eval()
    mel = torch.from_numpy(np.random.default_rng(3).random((2, 128, 64)).astype(np.float32))
    port = convert.load_cola_efficientnet_ckpt(oracle.state_dict(), Cola(encoder="efficientnet"))
    calibrate_bn(port.encoder, mel)
    oracle.load_state_dict(port.state_dict())
    with torch.no_grad():
        want = oracle.extract_feature(mel, dim).numpy()
    got = port.eval().extract_feature(mel, dim).numpy()
    _close(got, want, 1e-5, dim)


def test_reference_checkpoint_file_loads_by_name(tmp_path):
    """A Lightning-style .ckpt ({"state_dict": ...} with efficientnet-pytorch's
    _fc head, which the port does not hold) loads; a missing key raises."""
    torch.manual_seed(1)
    sd = ColaCEEval().state_dict()
    sd["encoder.efficientnet._fc.weight"] = torch.zeros(1000, 1280)
    path = str(tmp_path / "encoder-operaCE.ckpt")
    torch.save({"state_dict": sd}, path)
    port = convert.load_cola_efficientnet_ckpt(path, Cola(encoder="efficientnet"))
    assert torch.equal(port.state_dict()["encoder.efficientnet._blocks.3._depthwise_conv.weight"],
                       sd["encoder.efficientnet._blocks.3._depthwise_conv.weight"])
    del sd["g.weight"]
    with pytest.raises(KeyError, match="lacks 1 keys"):
        convert.load_cola_efficientnet_ckpt(sd, Cola(encoder="efficientnet"))


def test_from_jax_efficientnet_round_trip_is_exact(variables):
    """from_jax_efficientnet -> the JAX package's convert_cola_efficientnet
    gives back the same flax tree, leaf for leaf, params and batch_stats."""
    sd = {k: t.numpy() for k, t in convert.from_jax_efficientnet(variables).items()}
    back = jconvert.convert_cola_efficientnet(sd)

    def leaves(tree, prefix=()):
        for k, x in tree.items():
            if isinstance(x, dict):
                yield from leaves(x, prefix + (k,))
            else:
                yield prefix + (k,), x

    for part in ("params", "batch_stats"):
        want, got = dict(leaves(variables[part])), dict(leaves(back[part]))
        assert set(got) == set(want), part
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=str(k))
    Cola(encoder="efficientnet").load_state_dict(convert.from_jax_efficientnet(variables))


@pytest.fixture(scope="module")
def cola_step():
    """One float32 COLA step of the JAX package (p = 0): the loss, its
    gradients, the pair outputs and the new batch_stats, on a (4, 96, 64)
    pair, with its initial variables."""
    v = _jax_init(p=0.0, seed=4)
    model = JCola(ColaConfig(encoder="efficientnet", p=0.0))
    r = np.random.default_rng(5)
    x1, x2 = (r.standard_normal((4, 96, 64)).astype(np.float32) for _ in range(2))

    def loss_fn(params, bs):
        (z1, z2), new = model.apply({"params": params, "batch_stats": bs}, (x1, x2), train=True,
                                    rngs={"dropout": jax.random.PRNGKey(0)},
                                    mutable=["batch_stats"])
        loss, _ = jcola_loss(z1, z2)
        return loss, (z1, z2, new["batch_stats"])

    (loss, (z1, z2, new)), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["batch_stats"])
    return v, x1, x2, float(loss), np.asarray(z1), np.asarray(z2), jax.device_get(new), \
        jax.device_get(g)


def test_train_forward_and_bn_statistics_match_flax(cola_step):
    """Cola.train_pair against flax's pair forward with mutable batch_stats:
    both views' outputs, and all 49 BatchNorms' new running statistics
    (biased fast variance, momentum 0.99, chained through the two views)."""
    v, x1, x2, _, z1, z2, new, _ = cola_step
    port = _port(v, p=0.0).train()
    (p1, p2), stats = port.train_pair(torch.from_numpy(x1), torch.from_numpy(x2), None, 0.0)
    with torch.no_grad():
        (e1, e2), _ = _port(v, p=0.0).double().train_pair(
            torch.from_numpy(x1).double(), torch.from_numpy(x2).double(), None, 0.0)
    for got, want, exact, tag in ((p1, z1, e1, "z1"), (p2, z2, e2, "z2")):
        got, exact = got.detach().double().numpy(), exact.numpy()
        _close(got, want, TRAIN_OUT_TOL, tag)
        assert np.abs(got - exact).max() <= max(np.abs(want - exact).max(), STATS_TOL), tag
    named = _named(port, stats)
    want = convert.from_jax_efficientnet({"params": v["params"], "batch_stats": new})
    assert len(named) == 49
    for name, (mean, var) in named.items():
        _close(mean.numpy(), want[name + ".running_mean"].numpy(), STATS_TOL, name)
        _close(var.numpy(), want[name + ".running_var"].numpy(), STATS_TOL, name)
    # nothing was written into the model; commit writes the statistics
    assert torch.equal(port.encoder.efficientnet._bn0.running_mean,
                       torch.from_numpy(v["batch_stats"]["encoder"]["efficientnet"]["_bn0"]
                                        ["BatchNorm_0"]["mean"]))
    bn_mod.commit(stats)
    np.testing.assert_array_equal(port.encoder.efficientnet._bn0.running_mean.numpy(),
                                  named["encoder.efficientnet._bn0"][0].numpy())


def test_cola_step_float32_matches_jax(cola_step):
    """cola_training.forward_backward (torch autograd) against jax.grad of
    the same loss: the loss within 1e-5 relative, every gradient leaf within
    2e-4 of its scale."""
    v, x1, x2, lj, _, _, _, g = cola_step
    port = _port(v, p=0.0).train()
    loss, _, _ = ct.forward_backward(port, torch.from_numpy(x1), torch.from_numpy(x2), None,
                                     torch.float32, "autograd", 0.0)
    assert abs(float(loss) - lj) <= LOSS_RTOL * abs(lj), (float(loss), lj)
    want = convert.from_jax_efficientnet({"params": g})
    names = {n for n, _ in port.named_parameters()}
    assert names == set(want)
    for n, p in port.named_parameters():
        _close(p.grad.numpy(), want[n].numpy(), TOL, n)


def _leaf_cosines(a: dict, b: dict) -> np.ndarray:
    return np.array([float(a[k].ravel() @ b[k].ravel())
                     / (np.linalg.norm(a[k]) * np.linalg.norm(b[k]) + 1e-30) for k in sorted(a)])


def test_bf16_cola_step_stays_in_the_jax_class(cola_step):
    """The bf16 flow (bf16 convolutions, float32 BatchNorms) against strict
    float32, one COLA step from the same weights and pair, in both packages:
    the port's relative loss difference and median gradient-leaf cosine are
    no farther from float32 than twice the JAX package's own (a random-init
    EfficientNet's bf16 step is far from its float32 step in both: a few
    1e-2 of the loss and a median leaf cosine near 0.98; its BatchNorm biases'
    exact gradients are 0, as the next train-mode BatchNorm removes any
    constant, so their cosines are noise)."""
    v, x1, x2, lj32, _, _, _, g32 = cola_step
    model = JCola(ColaConfig(encoder="efficientnet", p=0.0, compute_dtype=jnp.bfloat16))

    def loss_fn(params, bs):
        (z1, z2), _ = model.apply({"params": params, "batch_stats": bs}, (x1, x2), train=True,
                                  mutable=["batch_stats"])
        return jcola_loss(z1, z2)[0]

    lj16, g16 = jax.jit(jax.value_and_grad(loss_fn))(v["params"], v["batch_stats"])
    jd = abs(float(lj16) - lj32) / abs(lj32)
    as_np = lambda g: {k: t.numpy().astype(np.float64) for k, t in
                       convert.from_jax_efficientnet({"params": jax.device_get(g)}).items()}
    jcos = np.median(_leaf_cosines(as_np(g32), as_np(g16)))
    port = {}
    for dt in (torch.float32, torch.bfloat16):
        m = _port(v, p=0.0).train()
        loss, _, _ = ct.forward_backward(m, torch.from_numpy(x1), torch.from_numpy(x2), None, dt,
                                         "autograd", 0.0)
        port[dt] = float(loss), {n: p.grad.numpy().astype(np.float64)
                                 for n, p in m.named_parameters()}
    pd = abs(port[torch.bfloat16][0] - port[torch.float32][0]) / abs(port[torch.float32][0])
    pcos = np.median(_leaf_cosines(port[torch.float32][1], port[torch.bfloat16][1]))
    print(f"bf16 vs float32 COLA step: JAX loss rel diff {jd:.3g}, median leaf cosine "
          f"{jcos:.6f}; port {pd:.3g}, {pcos:.6f}")
    assert pd <= 2 * jd + 1e-3, (pd, jd)
    assert 1 - pcos <= 2 * (1 - jcos) + 1e-4, (pcos, jcos)


def test_drop_connect_keeps_or_drops_whole_samples():
    """Train mode on a skip block: each sample's branch is either dropped or
    scaled by 1 / keep (floor(keep + U), U from the caller's generator); the
    same generator seed draws the same masks; eval mode never drops."""
    blk = eff.MBConv(16, 16, 3, 1, 6, 0.25, 0.5)
    from heart_murmur_detection_tpu_torch.models.htsat import init_weights

    init_weights(blk, torch.Generator().manual_seed(0))
    x = torch.randn(64, 16, 8, 8, generator=torch.Generator().manual_seed(1))
    blk.drop = 0.0
    branch = blk(x, stats={}) - x
    blk.drop = 0.5
    got = (blk(x, stats={}, gen=torch.Generator().manual_seed(2)) - x).detach()
    kept = torch.isclose(got, 2.0 * branch, atol=1e-5).flatten(1).all(1)
    dropped = (got.abs() <= 1e-6).flatten(1).all(1)
    assert bool((kept | dropped).all()) and 10 < int(kept.sum()) < 54
    again = blk(x, stats={}, gen=torch.Generator().manual_seed(2)) - x
    assert torch.equal(again.detach(), got)
    assert torch.equal(blk(x) - x, blk(x) - x)


def test_bf16_flow_casts_convolutions_and_keeps_batchnorms_float32(monkeypatch):
    """dtype=bfloat16: every convolution gives bf16, every BatchNorm float32
    (the flax _BN.force_f32 island), the pooled features float32 and close
    to the float32 graph's."""
    model = Cola(encoder="efficientnet")
    from heart_murmur_detection_tpu_torch.models.htsat import init_weights

    init_weights(model, torch.Generator().manual_seed(0))
    seen = {"conv": set(), "bn": set()}
    orig = bn_mod.batch_norm

    def spy(bn, x, momentum, stats=None):
        seen["conv"].add(x.dtype)
        y = orig(bn, x, momentum, stats)
        seen["bn"].add(y.dtype)
        return y

    mel = torch.randn(2, 96, 64, generator=torch.Generator().manual_seed(3))
    monkeypatch.setattr(eff, "batch_norm", spy)
    h16 = model.encoder(mel, dtype=torch.bfloat16)
    monkeypatch.setattr(eff, "batch_norm", orig)
    h32 = model.encoder(mel)
    assert seen == {"conv": {torch.bfloat16}, "bn": {torch.float32}}
    assert h16.dtype == torch.float32
    cos = float(torch.nn.functional.cosine_similarity(h16.flatten(), h32.flatten(), dim=0).detach())
    assert cos > 0.99, cos


def _wav(path, sec, f0, sr=16000):
    r = np.random.default_rng(int(f0))
    t = np.arange(int(sec * sr)) / sr
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.02 * r.standard_normal(len(t))
    write_wav(path, x.astype(np.float32), sr)
    return path


def test_feature_extractor_matches_jax(tmp_path, monkeypatch):
    """FeatureExtractor("operaCE") (dim 1280 by default, clips uncapped,
    every batch padded to the longest clip) against the JAX extractor on the
    same weights and files: the JAX init with its running statistics
    calibrated on the clips' mels, so that the features depend on the clip.
    The error is held relative to the features' own scale."""
    from heart_murmur_detection_tpu_torch.audio import dsp

    monkeypatch.setenv("HMDT_CACHE", str(tmp_path / "cache"))
    monkeypatch.setattr(jregistry, "_cached_init",
                        lambda kind, init_fn, cpu: jax.device_get(jax.jit(init_fn)()))
    wavs = [_wav(str(tmp_path / f"c{i}.wav"), 5.0 + 4 * i, 90 + 20 * i) for i in range(3)]
    jex = JFeatureExtractor("operaCE", input_sec=8, batch_size=2, random_init=True,
                            compute_dtype=jnp.float32)
    ex = FeatureExtractor("operaCE", input_sec=8, batch_size=2, random_init=True, device="cpu")
    assert ex.dim == 1280 and ex.max_sec is None
    ex.model.load_state_dict(convert.from_jax_efficientnet(jax.device_get(jex.variables)))
    wav, lengths = dsp.pad_batch([ex._clip_waveform(w) for w in wavs])
    mel, _ = dsp.mel_frontend(torch.from_numpy(wav), torch.from_numpy(lengths))
    for blk in ex.model.encoder.efficientnet._blocks:
        blk.drop = 0.0
    calibrate_bn(ex.model.encoder, mel)
    jex.variables = jax.device_put(jconvert.convert_cola_efficientnet(
        {k: t.numpy() for k, t in ex.model.state_dict().items()}), jax.devices("cpu")[0])
    want = jex.extract_files(wavs)
    got = ex.extract_files(wavs)
    assert got.shape == want.shape == (3, 1280)
    err = float(np.abs(got - want).max())
    assert err <= FEAT_RTOL * float(np.abs(want).max()), err
    # the clips' features differ far beyond that error
    for i, j in ((0, 1), (0, 2), (1, 2)):
        assert np.abs(got[i] - got[j]).max() > 0.1 * np.abs(got).max(), (i, j)
    # the functional API (model_util.extract_opera_feature): the same
    # extractor on the registry's seed-0 weights
    from heart_murmur_detection_tpu_torch.extract.extract import extract_opera_feature

    seeded = FeatureExtractor("operaCE", dim=512, input_sec=8, batch_size=2, random_init=True,
                              device="cpu").extract_files(wavs)
    np.testing.assert_array_equal(
        extract_opera_feature(wavs, dim=512, batch_size=2, random_init=True, device="cpu"), seeded)


# ---------------------------------------------------------------------------
# the config defaults on the CPU
# ---------------------------------------------------------------------------


def _circor_corpus(root):
    """12 CirCor patients at 4 kHz, one 2-7.5 s clip each (Present: a 150 Hz
    tone), six train, three validation and three test."""
    for i in range(12):
        d = "training_data" if i < 6 else "validation_data" if i < 9 else "test_data"
        m = ("Present", "Absent", "Unknown")[i % 3]
        base = os.path.join(root, "datasets", "circor", d)
        os.makedirs(base, exist_ok=True)
        r = np.random.default_rng(i)
        n = int((2.0 + 0.5 * i) * 4000)
        x = 0.2 * r.standard_normal(n)
        if m == "Present":
            x += 0.3 * np.sin(2 * np.pi * 150 * np.arange(n) / 4000)
        write_wav(os.path.join(base, f"{200 + i}_AV.wav"), x.astype(np.float32), 4000)
        with open(os.path.join(base, f"{200 + i}.txt"), "w") as f:
            f.write(f"#Murmur: {m}\n#Outcome: Normal\n" + "".join(
                f"#Systolic murmur {k}: nan\n" for k in
                ("timing", "shape", "grading", "pitch", "quality")))


def test_cli_defaults_process_linear_eval_and_null_on_cpu(tmp_path, monkeypatch):
    """cli.process and cli.linear_eval on their config defaults (pretrain
    operaCE, dim 1280) write and probe operaCE1280_feature.npy; the random
    baseline null-efficientnet does the same; without random_init the
    missing OPERA-CE checkpoint raises FileNotFoundError with its path."""
    from heart_murmur_detection_tpu_torch.cli import linear_eval, process

    _circor_corpus(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="encoder-operaCE.ckpt"):
        process.main(["dataset=circor", "device=cpu"])
    (out,) = process.main(["dataset=circor", "random_init=True", "device=cpu"])
    assert out == "feature/circor_eval/operaCE1280_feature.npy"
    feats = np.load(out)
    assert feats.shape == (12, 1280) and np.isfinite(feats).all()
    ((s0, s1),) = linear_eval.main(["task=circor_murmurs", "n_run=2", "device=cpu"])
    assert np.isfinite([s0, s1]).all()
    (out,) = process.main(["dataset=circor", "pretrain=null-efficientnet", "dim=512",
                           "device=cpu"])
    assert out == "feature/circor_eval/null-efficientnet512_feature.npy"
    assert np.load(out).shape == (12, 512)


def test_cli_pretrain_efficientnet_on_cpu(tmp_path, monkeypatch):
    """cli.pretrain encoder=efficientnet (the config's default encoder) takes
    an epoch on two small corpora in float32 and in bf16: finite losses, the
    BatchNorms' running statistics updated, top-k checkpoints of a
    Cola(efficientnet) state_dict."""
    from heart_murmur_detection_tpu_torch.cli import pretrain

    monkeypatch.chdir(tmp_path)
    r = np.random.default_rng(0)
    d = "feature/circor_eval"
    os.makedirs(os.path.join(d, "spec"))
    names = []
    for i in range(12):
        np.save(os.path.join(d, "spec", f"{i}.npy"),
                r.standard_normal((int(r.integers(260, 400)), 64)).astype(np.float32))
        names.append(os.path.join(d, "spec", str(i)))
    np.save(os.path.join(d, "entire_spec_filenames.npy"), np.array(names))
    for dt in ("float32", "bfloat16"):
        ((sd, history, _),) = pretrain.main([
            "circor=True", "batch_size=4", "epoches=1", "device=cpu", f"compute_dtype={dt}",
            f"title=ce-{dt}"])
        assert np.isfinite(history[0]["train_loss"]) and np.isfinite(history[0]["valid_loss"])
        assert "encoder.efficientnet._blocks.15._bn2.running_var" in sd
        assert not torch.equal(sd["encoder.efficientnet._bn0.running_mean"], torch.zeros(32))
