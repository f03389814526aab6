"""The tensor axis on gloo ranks spawned on the CPU: dp2 x tp2
(parallel/mesh.py::mesh_2d, parallel/tensor.py, models/tp_blocks.py), every
case in one launch of four ranks (R.cases), against the JAX package on
mesh_2d(2, 2) and the port's single-device run, strict float32, dropout and
DropPath off where runs are compared:
- COLA continued pretraining (HTS-AT), megatron and fsdp over the model
  axis, against the JAX megatron run (tests/test_parallel.py:379) and one
  device: every epoch's losses at rtol 1e-4, final parameters at rtol 1e-3
  (tests/test_torch_parallel_cola.py's bars); every rank's state bit for
  bit the same;
- resume of a megatron run from its epoch-4 checkpoint runs epochs
  [5, 6, 7] (:485) and ends where the uninterrupted run does; the
  checkpoint holds single-device tensors, which load into a one-device
  Cola by name;
- MAE continued pretraining (ViT encoder, SwinV2-CR decoder), megatron,
  fed the JAX loop's masking noise, against JAX on mesh_2d(2, 2) and one
  device (tests/test_torch_parallel_mae.py's bars);
- fine-tuning with an mlp head (the HTS-AT) and of the operaGT ViT,
  megatron, against one device (valid AUROC rtol 1e-3, the JAX oracle's
  parameter bar, :557);
- step-0 gradients of the COLA, MAE and fine-tuning steps leaf by leaf
  (tests/test_torch_parallel_step0.py's bar), and each rank's shards
  holding 1/tp of the rows or columns;
- draws at rate > 0: model peers draw alike, data ranks differently, and a
  run with dropout and DropPath on keeps the ranks' states equal;
- the dry run's dp x tp case (parallel/dryrun.py);
- operaCT extraction on the 2-D mesh: rows over all four ranks, the weights
  whole on each, the plain path (the JAX extractor's, extract.py:77-80),
  the one-device rows at rtol 1e-4;
- cli.pretrain and cli.finetune (operaCT, then HeAR) with dp=2 tp=2
  dist_backend=gloo, called in every rank as under torchrun
  (parallel/launch.py takes the group);
- every encoder kind under megatron: step-0 gradients of CLAP 2022 (the
  Cnn14's fc1 column-parallel, at full width), CLAP 2023 and HeAR (their
  towers narrowed in the ranks, R.NARROW_ZOO) against one device, and a
  2-epoch fine-tuning of HeAR against the JAX run on mesh_2d(2, 2);
- the head split: an HTS-AT and a gt ViT with 3 heads (3C divides over 2
  model ranks, the heads do not): step-0 gradients against one device, each
  rank's contiguous 3C / 2 qkv rows, and 2 epochs against the JAX run on
  mesh_2d(2, 2) (GSPMD's own split), whose gathered state is the
  single-device layout; and HeAR's head split at tp=3 on three of the
  four ranks, where the proj stays replicated.
The single-device and JAX runs run in this process while the ranks work."""

import concurrent.futures
import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heart_murmur_detection_tpu.train.finetune as jft
from heart_murmur_detection_tpu.models.htsat import HTSATConfig as JaxHTSATConfig
from heart_murmur_detection_tpu.parallel.mesh import mesh_2d
from heart_murmur_detection_tpu.pretrain import cola_training as jax_cola_training
from heart_murmur_detection_tpu.pretrain import data as jax_data
from heart_murmur_detection_tpu.pretrain import mae_training as jax_mae_training
from heart_murmur_detection_tpu_torch.extract import convert
from heart_murmur_detection_tpu_torch.extract.extract import FeatureExtractor
from heart_murmur_detection_tpu_torch.models.cola import Cola
from heart_murmur_detection_tpu_torch.models.htsat import HTSATConfig
from heart_murmur_detection_tpu_torch.models.vit_mae import MAEConfig
from heart_murmur_detection_tpu_torch.parallel import dryrun, launch
from heart_murmur_detection_tpu_torch.pretrain import cola_training, data, mae_training
from heart_murmur_detection_tpu_torch.train import checkpoints
from heart_murmur_detection_tpu_torch.train import finetune as ft
from tests import torch_parallel_ranks as R
from tests.test_torch_extract import _wav
from tests.test_torch_finetune import (GT_SMALL, KINDS, NEW_KINDS, TINY_HTSAT, _clf_data,
                                       _new_jax, apply_narrow_zoo)
from tests.test_torch_mae_train import _cfgs, _jax_step_noises, _jinit, synth_corpus
from tests.test_torch_parallel_cola import TINY, _args, _close_params, _jax_init as _jax_cola_init
from tests.test_torch_parallel_cola import corpus
from tests.test_torch_parallel_finetune import KW as FT_KW
from tests.test_torch_parallel_finetune import _params_close
from tests.test_torch_parallel_mae import EPOCHS, _common
from tests.test_torch_parallel_mae import _close_params as _mae_close_params
from tests.test_torch_parallel_misc import _spec_corpus
from tests.test_torch_parallel_step0 import _cases as _step0_cases
from tests.test_torch_parallel_step0 import NORM_TOL, _grad_rule

COLA = "heart_murmur_detection_tpu_torch.pretrain.cola_training:train_multiple_data"
MAE = "heart_murmur_detection_tpu_torch.pretrain.mae_training:mae_train_multiple_data"
FT = "heart_murmur_detection_tpu_torch.train.finetune:finetune_classifier"


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads in the test process (the ranks take one each):
    the test run shares the cores among its xdist workers (see
    test_torch_swin.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ft_args(kind="htsat"):
    x, y = _clf_data(kind, 32, seed=5) if kind != "hear" else _hear_data(32, seed=5)
    return dict(x_train=x[:16], y_train=y[:16], x_val=x[16:24], y_val=y[16:24], x_test=x[24:],
                y_test=y[24:])


def _hear_data(n, seed):
    """2-s clips at 16 kHz: noise, and a 440 Hz tone in class 1."""
    r = np.random.default_rng(seed)
    y = r.integers(0, 2, n).astype(np.int32)
    t = np.arange(32000) / 16000.0
    x = 0.05 * r.standard_normal((n, 32000)) + 0.2 * y[:, None] * np.sin(2 * np.pi * 440 * t)
    return x.astype(np.float32), y


# the head split: 3 heads, which 2 model ranks do not divide (3C does)
HS_HTSAT = {**TINY_HTSAT, "embed_dim": 24, "depths": (1, 1), "num_heads": (3, 3)}
HS_GT = {**GT_SMALL, "embed_dim": 96, "num_heads": 3}
HS_FEAT = {"htsat": 48, "gt": 96}
ZOO = ("clap", "clap2023", "hear")
# The Cnn14's step 0 runs in float64 on both sides: its bn0 normalises dB
# log-mels (a mean far from 0 against the spread), and the float32 one-device
# BatchNorm's gradient of bn0 and the first conv block stands 1.6e-3 (bn0)
# to 4.7e-3 (conv_block1.conv2) of the largest gradient entry from the
# float64 step on this batch, the synced BatchNorm of the mesh 2.9e-4, both
# over the bar's 3e-5.
STEP0_DTYPE = {"clap": torch.float64}


def _step0_batch(shape, wave: bool):
    """The step-0 batch of tests/test_torch_parallel_step0.py's fine-tuning
    case (B=8, rank 0 class 0 only, two padded rows) at another input."""
    r = np.random.default_rng(13)
    x = r.standard_normal((8,) + shape).astype(np.float32) * (0.1 if wave else 1.0)
    y = np.array([0, 0, 0, 0, 1, 0, 1, 1], np.int64)
    valid = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    return dict(x=x, y=y, valid=valid, cw=np.array([0.3, 1.7], np.float32))


def _jax_clf_init(jmodel, shape):
    """The JAX finetune_classifier's init of its classifier (seed 0)."""
    return jax.tree.map(np.asarray, jax.device_get(jax.jit(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1,) + shape)))()))


@contextlib.contextmanager
def _hs_gt():
    """The JAX package's gt classifier at HS_GT (3 heads) while it lasts."""
    from heart_murmur_detection_tpu.models import vit_mae as jvit

    gt_cfg = lambda **kw: jvit.MAEConfig(**{**HS_GT, **kw})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvit, "mae_vit_small_config", gt_cfg)
        mp.setattr(jft, "mae_vit_small_config", gt_cfg)
        yield


def _zoo_cases():
    """Slice 10's rank cases and what the test process compares them with:
    (cases, {name: kwargs} of the step-0 cases, {kind: JAX init}), under
    apply_narrow_zoo's patches."""
    step0, cases = {}, {}
    for kind in ZOO:
        clf = ft.EncoderClassifier(kind, 2, "linear", 0,
                                   generator=torch.Generator().manual_seed(2))
        step0[f"zoo-{kind}"] = dict(state=clf.state_dict(), kind=kind, htsat=TINY_HTSAT,
                                    megatron=True, dtype=STEP0_DTYPE.get(kind, torch.float32),
                                    **_step0_batch(NEW_KINDS[kind][0], wave=True))
    hs = {"htsat": ft.EncoderClassifier("htsat", 2, "linear", 48, HTSATConfig(**HS_HTSAT),
                                        generator=torch.Generator().manual_seed(2)),
          "gt": ft.EncoderClassifier("gt", 2, "linear", 96, mae_config=MAEConfig(**HS_GT),
                                     generator=torch.Generator().manual_seed(2))}
    for kind, clf in hs.items():
        step0[f"hs-{kind}"] = dict(state=clf.state_dict(), kind=kind, htsat=HS_HTSAT,
                                   mae=HS_GT if kind == "gt" else None, feat_dim=HS_FEAT[kind],
                                   megatron=True, **_step0_batch(KINDS[kind][0], wave=False))
    cases.update({f"step0-{k}": ("call", dict(target="tests.torch_parallel_ranks:ft_step0",
                                              kwargs=kw, patches=R.NARROW_ZOO))
                  for k, kw in step0.items()})
    cases["step0-hear-tp3"] = ("sub_mesh_ft_step0", dict(n_model=3, patches=R.NARROW_ZOO,
                                                         **step0["zoo-hear"]))
    jinit = {"hear": _new_jax("hear")[1],
             "htsat": _jax_clf_init(jft.EncoderClassifier(
                 encoder_kind="htsat", classes=2, feat_dim=48,
                 htsat_config=JaxHTSATConfig(enable_tscam=False, **HS_HTSAT)), KINDS["htsat"][0])}
    with _hs_gt():
        jinit["gt"] = _jax_clf_init(
            jft.EncoderClassifier(encoder_kind="gt", classes=2, feat_dim=96), KINDS["gt"][0])
    for kind in ("hear", "htsat", "gt"):
        kw = {**FT_KW, **_ft_args(kind), "encoder_kind": kind, "epochs": 2, "device": "cpu",
              "param_sharding": "megatron",
              "init_state": convert.from_jax_classifier(jinit[kind], kind)}
        if kind == "hear":
            kw["feat_dim"] = NEW_KINDS["hear"][1]
        else:
            kw["feat_dim"] = HS_FEAT[kind]
            kw.update({"htsat_config": HTSATConfig(**HS_HTSAT)} if kind == "htsat" else
                      {"mae_config": MAEConfig(**HS_GT)})
        cases[f"ft-{kind}-megatron"] = ("run_peers", dict(target=FT, kwargs=kw,
                                                          patches=R.NARROW_ZOO))
    return cases, step0, jinit


def _jax_zoo_runs():
    """The JAX finetune_classifier runs of slice 10 on mesh_2d(2, 2) under
    megatron (HeAR narrowed, the 3-head towers; the caller holds the
    patches): {kind: the final state in the port's names, FTResult}."""
    out = {}
    for kind in ("hear", "htsat", "gt"):
        a = _ft_args(kind)
        kw = dict(encoder_kind=kind, n_cls=2, lr=1e-3, epochs=2, batch_size=8, seed=0,
                  l2_strength=1e-3, mesh=mesh_2d(2, 2), param_sharding="megatron")
        if kind == "hear":
            kw["feat_dim"] = NEW_KINDS["hear"][1]
        else:
            kw["feat_dim"] = HS_FEAT[kind]
        if kind == "htsat":
            kw["htsat_config"] = JaxHTSATConfig(enable_tscam=False, **HS_HTSAT)
        with _hs_gt():
            res = jft.finetune_classifier(a["x_train"], a["y_train"], a["x_val"], a["y_val"],
                                          a["x_test"], a["y_test"], **kw)
        out[kind] = convert.from_jax_classifier(jax.device_get(res.variables), kind), res
    return out




def _cli_corpus(root):
    _spec_corpus(root)
    d = root / "feature" / "circor_eval"
    r = np.random.default_rng(0)
    y = np.arange(24) % 2
    np.save(d / "murmurs.npy", y)
    np.save(d / "train_test_split.npy", np.array(["train"] * 16 + ["val"] * 4 + ["test"] * 4))
    np.save(d / "spectrogram_pad8.npy",
            (r.random((24, 256, 64)) + 0.5 * y[:, None, None]).astype(np.float32))
    np.save(d / "sound_dir_loc.npy", np.array([f"{i}.wav" for i in range(24)]))
    np.save(d / "fbank_hear.npy", _hear_data(24, seed=0)[0])  # HeAR's first-window cache


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    init = convert.from_jax(_jax_cola_init())
    cola = lambda tag, ps, n_epoches=2, **kw: _args(
        root / tag, n_epoches, corpora=[corpus()], htsat_config=HTSATConfig(**TINY),
        encoder="htsat", initial_state=init, param_sharding=ps, **kw)
    jcfg, mcfg = _cfgs(mask_ratio=0.7)
    _, v0 = _jinit(jcfg)
    minit = convert.from_jax_mae(v0, decoder=True)
    noises = _jax_step_noises(0, 2 * EPOCHS, 4, 32)
    mae = lambda tag, **kw: dict(corpora=[synth_corpus("a", 4, 4, 20, 60, 16, 32, data, 3)],
                                 config_override=mcfg, initial_state=minit,
                                 **_common(root / tag), **kw)
    # a Feed of its own for each run
    feed = lambda: (("heart_murmur_detection_tpu_torch.models.mae_train_fused", "masking_noise",
                     R.Feed(noises)),)
    ft_kw = {**FT_KW, "htsat_config": HTSATConfig(**TINY_HTSAT), "device": "cpu", "head": "mlp",
             "init_state": None, **_ft_args()}
    gt_kw = {**FT_KW, "encoder_kind": "gt", "mae_config": MAEConfig(**GT_SMALL), "epochs": 2,
             "device": "cpu", **_ft_args("gt")}
    step = _step0_cases(2)
    step["cola-dp"][1]["state"] = init
    ftc = ft.EncoderClassifier("htsat", 2, "mlp", 128, HTSATConfig(**TINY_HTSAT),
                               generator=torch.Generator().manual_seed(2))
    step0 = {"cola": ("cola_step0", {**step["cola-dp"][1], "megatron": True}),
             "mae": ("mae_step0", {**step["mae-dp"][1], "megatron": True}),
             "ft": ("ft_step0", {**step["ft-dp"][1], "state": ftc.state_dict(), "head": "mlp",
                                 "megatron": True})}
    os.makedirs(root / "cli")
    _cli_corpus(root / "cli")
    wavs = [_wav(str(root / f"c{i}.wav"), 6.0 + 2 * i, 80 + 10 * i) for i in range(3)]
    ex_kw = dict(dim=768, input_sec=8, batch_size=4, random_init=True,
                 compute_dtype=torch.float32, device="cpu")
    ex_state = FeatureExtractor("operaCT", **ex_kw).model.state_dict()
    cases = {
        "cola-megatron": ("run_peers", dict(target=COLA, kwargs=cola("m", "megatron"))),
        "cola-fsdp": ("run_peers", dict(target=COLA, kwargs=cola("f", "fsdp"))),
        "resume": ("resume_runs", dict(target=COLA, args8=cola("r", "megatron", 8))),
        "mae": ("run_peers", dict(target=MAE, kwargs=mae("mae", param_sharding="megatron"),
                                  patches=feed())),
        "ft": ("run_peers", dict(target=FT, kwargs={**ft_kw, "param_sharding": "megatron"})),
        "ft-gt": ("run_peers", dict(target=FT, kwargs={**gt_kw, "param_sharding": "megatron"})),
        **{f"step0-{k}": v for k, v in step0.items()},
        "draws": ("peer_draws", dict(seed=3, rows=4)),
        "dropout": ("run_peers", dict(target=COLA, kwargs={
            **cola("d", "megatron", 1), "dropout_p": 0.1,
            "htsat_config": HTSATConfig(**{**TINY, "drop_path_rate": 0.2})})),
        "dryrun": ("call", dict(target="heart_murmur_detection_tpu_torch.parallel.dryrun:run_case",
                                kwargs=dict(case="tp", n=4, root=str(root / "dry"),
                                            device="cpu"))),
        "cli": ("cli_tp_runs", dict(root=str(root / "cli"))),
        "extract": ("extract_rows", dict(state=ex_state, paths=wavs, kw=ex_kw)),
    }
    with pytest.MonkeyPatch.context() as mp, \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        apply_narrow_zoo(mp)
        zoo, zoo_step0, jinit = _zoo_cases()
        cases.update(zoo)
        ranks = pool.submit(launch, R.cases, 4, cases, device="cpu", tp=2)
        out = {"init": init, "minit": minit, "root": root, "jinit": jinit,
               "jax-zoo": _jax_zoo_runs()}
        out["one-zoo-step0"] = {k: R.ft_step0(None, **{**kw, "megatron": False})
                                for k, kw in zoo_step0.items()}
        # the JAX runs on mesh_2d(2, 2) (its MAE init jitted, as the DP tests do)
        eager = jax_mae_training.MaskedAutoencoderViT.init
        jax_mae_training.MaskedAutoencoderViT.init = lambda self, rngs, *a: jax.jit(
            lambda xs: eager(self, rngs, *xs))(a)
        try:
            jv, jh, _ = jax_mae_training.mae_train_multiple_data(
                corpora=[synth_corpus("a", 4, 4, 20, 60, 16, 32, jax_data, 3)],
                config_override=jcfg, mesh=mesh_2d(2, 2), param_sharding="megatron",
                **_common(root / "jmae"))
        finally:
            jax_mae_training.MaskedAutoencoderViT.init = eager
        out["jax-mae"] = convert.from_jax_mae(jax.tree.map(np.asarray, jv), decoder=True), jh
        from heart_murmur_detection_tpu.models.cola import Cola as JaxCola

        eager = JaxCola.init
        JaxCola.init = lambda self, rng, *a: jax.jit(lambda r, xs: eager(self, r, *xs))(rng, a)
        try:
            jv, jh, _ = jax_cola_training.train_multiple_data(
                corpora=[corpus(jax_data)], encoder="htsat",
                htsat_config=JaxHTSATConfig(enable_tscam=False, **TINY), mesh=mesh_2d(2, 2),
                param_sharding="megatron", **_args(root / "jcola", 2))
        finally:
            JaxCola.init = eager
        out["jax-cola"] = convert.from_jax(jax.tree.map(np.asarray, jv)), jh
        # the port on one device
        sd, h, _ = cola_training.train_multiple_data(device="cpu", **cola("one", None))
        out["one-cola"] = sd, h
        with R.patched(feed()):
            sd, h, _ = mae_training.mae_train_multiple_data(device="cpu", **mae("one-mae"))
        out["one-mae"] = sd, h
        out["one-ft"] = ft.finetune_classifier(**ft_kw)
        out["one-ft-gt"] = ft.finetune_classifier(**gt_kw)
        out["one-step0"] = {k: getattr(R, fn)(None, **{**kw, "megatron": False})
                            for k, (fn, kw) in step0.items()}
        out["one-dryrun"] = dryrun.run_case(None, "dp", 4, str(root / "dry"), "cpu")
        one = FeatureExtractor("operaCT", **ex_kw)
        one.model.load_state_dict(ex_state)
        out["one-extract"] = one.extract_files(wavs)
        out.update(ranks.result())
    return out


def _same_on_every_rank(dig):
    assert len(dig) == 4
    for other in dig[1:]:
        assert other == dig[0], [k for k in dig[0] if other[k] != dig[0][k]][:5]


@pytest.mark.parametrize("rule", ["megatron", "fsdp"])
def test_tp_cola_matches_jax_and_one_device(runs, rule):
    (sd, h, _), dig = runs[f"cola-{rule}"]
    jsd, jh = runs["jax-cola"]
    sd1, h1 = runs["one-cola"]
    assert [e["steps"] for e in h] == [2, 2] and [e["pairs"] for e in h] == [8, 8]
    for a, b, c in zip(h, jh, h1):
        for q in ("train_loss", "valid_loss"):
            np.testing.assert_allclose(a[q], b[q], rtol=1e-4)
            np.testing.assert_allclose(a[q], c[q], rtol=1e-4)
    _close_params(sd, jsd, runs["init"])
    _close_params(sd, sd1, runs["init"])
    assert set(sd) == set(sd1) and all(sd[k].shape == sd1[k].shape for k in sd)
    _same_on_every_rank(dig)


def test_tp_resume_equals_the_uninterrupted_run(runs):
    """resume=True from the epoch-4 resume checkpoint of an 8-epoch megatron
    run: epochs [5, 6, 7] and the uninterrupted run's state; the
    checkpoint's weights (full size) load into a one-device Cola by name,
    and its Adam moments have the parameters' full shapes."""
    (h8, sd8), (hr, sdr) = runs["resume"]
    assert [e["epoch"] for e in h8] == list(range(8))
    assert [e["epoch"] for e in hr] == [5, 6, 7]
    for a, b in zip(hr, h8[5:]):
        assert (a["train_loss"], a["valid_loss"]) == (b["train_loss"], b["valid_loss"])
    for k, v in sd8.items():
        assert torch.equal(sdr[k], v), k
    ck = checkpoints.load_state(str(runs["root"] / "r" / "cks" / "a" / "dp" / "last.ckpt"))
    assert ck["epoch"] == 4
    model = Cola(HTSATConfig(**TINY), encoder="htsat", p=0.0)
    model.load_state_dict(ck["state_dict"])
    shapes = [p.shape for p in model.parameters()]
    moments = ck["optimizer"]["adam"]["state"]
    assert len(moments) == len(shapes)
    for i, s in enumerate(shapes):
        assert moments[i]["exp_avg"].shape == s and moments[i]["exp_avg_sq"].shape == s


def test_tp_mae_cp_matches_jax_and_one_device(runs):
    (sd, h, _), dig = runs["mae"]
    jsd, jh = runs["jax-mae"]
    sd1, h1 = runs["one-mae"]
    assert [e["samples"] for e in h] == [4] * EPOCHS
    for a, b, c in zip(h, jh, h1):
        for q in ("train_loss", "valid_loss"):
            np.testing.assert_allclose(a[q], b[q], rtol=1e-4)
            np.testing.assert_allclose(a[q], c[q], rtol=1e-4)
    _mae_close_params(sd, jsd, runs["minit"])
    _mae_close_params(sd, sd1, runs["minit"])
    _same_on_every_rank(dig)


@pytest.mark.parametrize("case", ["ft", "ft-gt"])
def test_tp_finetune_matches_one_device(runs, case):
    """The HTS-AT with an mlp head (fc1 / fc2 over the model axis) and the
    operaGT ViT (its blocks; predictions through models/vit_fused.py)."""
    res, dig = runs[case]
    one = runs[f"one-{case}"]
    assert res.best_epoch == one.best_epoch
    np.testing.assert_allclose(res.valid_auc, one.valid_auc, rtol=1e-3)
    np.testing.assert_allclose(res.test_auc, one.test_auc, rtol=1e-3)
    _params_close(res.state_dict, one.state_dict)
    _same_on_every_rank(dig)


@pytest.mark.parametrize("case", ["cola", "mae", "ft"])
def test_tp_step0_gradients_match_one_device(runs, case):
    got, want = runs[f"step0-{case}"], runs["one-step0"][case]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    off, ratio = _grad_rule(want[1], got[1])
    assert not off, (case, off[:5])
    assert abs(ratio - 1) <= NORM_TOL, ratio
    if case == "mae":  # the global batch's masks
        assert torch.equal(got[2], want[2])


def test_tp_shards_hold_a_part_of_each_column_and_row_layer(runs):
    """On each model rank: qkv (3C / 2, C), fc1 (4C / 2, C), proj (C, C / 2),
    fc2 (C, 4C / 2); everything else at its single-device shape."""
    shapes = runs["step0-cola"][3]
    full = {k: tuple(v.shape) for k, v in runs["init"].items()}
    for k, s in shapes.items():
        if k.endswith(("qkv.weight", "fc1.weight")):
            assert s == (full[k][0] // 2, full[k][1]), k
        elif k.endswith(("attn.proj.weight", "fc2.weight")):
            assert s == (full[k][0], full[k][1] // 2), k
        else:
            assert s == full[k], k
    assert shapes["encoder.encoder.htsat.layers.0.blocks.0.attn.qkv.weight"] == (24, 16)


def test_model_peers_draw_alike(runs):
    """rank_generator folds in the data index only: ranks 0 / 1 and 2 / 3
    (model peers) draw the same DropPath and dropout masks, the two data
    ranks different ones; a megatron run with dropout 0.1 and DropPath 0.2
    leaves every rank's state bit for bit the same."""
    d = runs["draws"]
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    assert same(d[0], d[1]) and same(d[2], d[3]) and not same(d[0], d[2])
    (_, h, _), dig = runs["dropout"]
    assert np.isfinite(h[0]["train_loss"])
    _same_on_every_rank(dig)


def test_dryrun_tp_case_matches_dp(runs):
    """parallel/dryrun.py's dp x tp case: its losses at the dry run's 2e-4
    of the DP case's one-device run (which the DP case matches)."""
    got = [(h["train_loss"], h["valid_loss"]) for h in runs["dryrun"]]
    want = [(h["train_loss"], h["valid_loss"]) for h in runs["one-dryrun"]]
    np.testing.assert_allclose(got, want, rtol=dryrun.TP_RTOL)


def test_cli_pretrain_and_finetune_dp2_tp2(runs):
    """The CLIs with dp=2 tp=2 dist_backend=gloo on the CPU: one COLA epoch
    (rank 0's result, the full state, the CSV written once) and one
    fine-tuning seed of operaCT and of HeAR (megatron; each checkpoint saved
    once and loading into a one-device classifier, a finite AUROC)."""
    ((sd, hist, _),), (scores,), (hear_scores,) = runs["cli"]
    root = runs["root"] / "cli"
    assert hist[0]["steps"] == 2 and np.isfinite(hist[0]["train_loss"])
    narrow = R.narrow_htsat()
    model = Cola(narrow, encoder="htsat", p=0.0)
    model.load_state_dict(sd)
    rows = open(root / "cks" / "logs" / "combined" / "t" / "metrics.csv").read().splitlines()
    assert len(rows) == 2
    assert len(scores) == 1 and np.isfinite(scores[0])
    assert len(hear_scores) == 1 and np.isfinite(hear_scores[0])
    d = root / "cks" / "finetune" / "circor_murmurs"
    ckpts = sorted(os.listdir(d))
    assert len(ckpts) == 2 and all(c.endswith(".pt") for c in ckpts)
    (ct,) = [c for c in ckpts if "_operaCT_" in c]
    (hr,) = [c for c in ckpts if "_hear_" in c]
    model = ft.EncoderClassifier("htsat", 2, "linear", 768, htsat_config=narrow)
    model.load_state_dict(checkpoints.load_params(str(d / ct)))
    with R.patched(R.NARROW_ZOO):
        model = ft.EncoderClassifier("hear", 2, "linear", 0)
    model.load_state_dict(checkpoints.load_params(str(d / hr)))


def test_extraction_spreads_rows_over_every_rank(runs):
    """FeatureExtractor(mesh=<dp2 x tp2>): 3 WAVs in a batch of 4 (one row
    a rank, the last padded), the encoder on the plain path with its
    weights whole: every rank's rows gathered equal the one-device rows."""
    got, impl = runs["extract"]
    assert impl == "plain" and got.shape == runs["one-extract"].shape == (3, 768)
    np.testing.assert_allclose(got, runs["one-extract"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", [f"zoo-{k}" for k in ZOO] + ["hs-htsat", "hs-gt"])
def test_tp_every_kind_and_the_head_split_step0_match_one_device(runs, case):
    """Step 0 of megatron fine-tuning (finetune.train_step at lr 0, B=8 over
    dp2 x tp2, an uneven class mix with padded rows) against one device,
    leaf by leaf at tests/test_torch_parallel_step0.py's bar: CLAP 2022
    (the Cnn14's fc1 column-parallel and its output all-gathered), CLAP 2023
    (its HTS-AT blocks), HeAR (its ViT blocks), and the head split (3
    heads over 2 model ranks: each rank holds the contiguous 3C / 2 rows of
    every qkv, the by-heads split's row count)."""
    got, want = runs[f"step0-{case}"], runs["one-zoo-step0"][case]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    off, ratio = _grad_rule(want[1], got[1])
    assert not off, (case, off[:5])
    assert abs(ratio - 1) <= NORM_TOL, ratio
    full = {k: tuple(g.shape) for k, g in want[1].items()}
    shapes = got[2]
    col = [k for k in full if k.endswith(("qkv.weight", "fc1.weight"))
           and not k.startswith("head.")]
    assert col, case
    for k in col:
        assert shapes[k] == (full[k][0] // 2, full[k][1]), k
    if case == "zoo-clap":
        assert col == ["encoder.base.fc1.weight"]
    unsharded = [k for k in full if k not in col and not k.endswith(("proj.weight",
                                                                        "fc2.weight"))]
    assert all(shapes[k] == full[k] for k in unsharded)


@pytest.mark.parametrize("kind", ["hear", "htsat", "gt"])
def test_tp_megatron_finetune_matches_jax_gspmd(runs, kind):
    """2 epochs of megatron fine-tuning at dp2 x tp2 from the JAX init
    against the JAX finetune_classifier on mesh_2d(2, 2) under megatron
    (tests/test_parallel.py:557's bars: the valid AUROC at rtol 1e-3, every
    parameter at rtol 1e-2, atol 1e-3): HeAR (narrowed), and the head split
    of a 3-head HTS-AT and a 3-head gt ViT, which GSPMD splits its own way.
    The state the ranks return (the checkpoint's) has the single-device
    layout: it loads into a one-device classifier by name."""
    res, dig = runs[f"ft-{kind}-megatron"]
    jsd, jres = runs["jax-zoo"][kind]
    assert res.best_epoch == jres.best_epoch
    np.testing.assert_allclose(res.valid_auc, jres.valid_auc, rtol=1e-3)
    _params_close(res.state_dict, jsd)
    _same_on_every_rank(dig)
    if kind == "hear":
        with R.patched(R.NARROW_ZOO):
            one = ft.EncoderClassifier("hear", 2, "linear", 0)
    elif kind == "htsat":
        one = ft.EncoderClassifier("htsat", 2, "linear", 48, HTSATConfig(**HS_HTSAT))
    else:
        one = ft.EncoderClassifier("gt", 2, "linear", 96, mae_config=MAEConfig(**HS_GT))
    want = one.state_dict()
    assert {k: tuple(v.shape) for k, v in res.state_dict.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    one.load_state_dict(res.state_dict)


def test_tp3_head_split_with_a_replicated_proj(runs):
    """HeAR's step 0 (narrowed: C 64, 2 heads) on a 1 x 3 tensor axis over
    three of the launch's ranks, as at tp=3: 3C divides by 3, so the qkv
    takes the head split (64 of its 192 rows a rank), while C and fc1's 4C
    do not, so the proj, fc1 and fc2 stay replicated and every rank hands
    the head outputs to the proj whole; against the same step on one
    device at the bar."""
    got, want = runs["step0-hear-tp3"], runs["one-zoo-step0"]["zoo-hear"]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    off, ratio = _grad_rule(want[1], got[1])
    assert not off, off[:5]
    assert abs(ratio - 1) <= NORM_TOL, ratio
    shapes, full = got[2], {k: tuple(g.shape) for k, g in want[1].items()}
    for k, s in shapes.items():
        assert s == ((full[k][0] // 3, full[k][1]) if k.endswith("qkv.weight") else full[k]), k
