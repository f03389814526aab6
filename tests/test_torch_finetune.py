"""Fine-tuning (train/finetune.py of the port) against the JAX package's
train/finetune.py on the same numpy inputs and the same JAX init (carried by
extract/convert.py::from_jax_classifier): one step's loss and every gradient
leaf in float32 for htsat, gt and audiomae (the JAX fused train kernels in
interpret mode and its flax path), 3 epochs to the same best epoch and
valid AUROC, freeze_encoder, the freeze predicate's name map, SpecAugment's
stripes, EarlyStopping / find_best_ckpt, the classifier converter, the CLI.

Sizes: the JAX tests' TINY_HTSAT (tests/test_finetune.py) with DropPath 0;
for gt and audiomae a 2-block C=128 MAE (2 heads of 64) on small images,
put in place of mae_vit_small_config / audiomae_base_config with
monkeypatch (the JAX package is not edited). Dropout and DropPath are zero
and SpecAugment is off wherever the two packages are compared."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import heart_murmur_detection_tpu.models.vit_mae as jvit
import heart_murmur_detection_tpu.train.finetune as jft
from heart_murmur_detection_tpu.audio import augment as jaug
from heart_murmur_detection_tpu.extract import convert as jconvert
from heart_murmur_detection_tpu.models.heads import freeze_mask_fn as jax_freeze_mask_fn
from heart_murmur_detection_tpu.models.htsat import HTSATConfig as JHTSATConfig
from heart_murmur_detection_tpu.train import checkpoints as jck
from heart_murmur_detection_tpu_torch.audio import augment
from heart_murmur_detection_tpu_torch.extract.convert import from_jax_classifier
from heart_murmur_detection_tpu_torch.models import vit_mae
from heart_murmur_detection_tpu_torch.models.heads import freeze_mask_fn
from heart_murmur_detection_tpu_torch.models.htsat import HTSATConfig
from heart_murmur_detection_tpu_torch.train import checkpoints as ck
from heart_murmur_detection_tpu_torch.train import finetune as ft


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TINY_HTSAT = dict(spec_size=64, patch_size=4, embed_dim=16, depths=(1, 1, 1, 1),
                  num_heads=(2, 2, 2, 2), window_size=2, mel_bins=16, drop_path_rate=0.0)
GT_SMALL = dict(img_size=(64, 32), patch_size=4, embed_dim=128, depth=2, num_heads=2)
AM_SMALL = dict(img_size=(128, 64), patch_size=16, embed_dim=128, depth=2, num_heads=2)
# (encoder kind, input (T, F), feature width)
KINDS = {"htsat": ((32, 16), 128), "gt": ((64, 32), 128), "audiomae": ((100, 64), 128)}
L2 = 1e-3
TOL = 2e-4  # the float32 class: loss and every gradient leaf, relative to the leaf's scale


@pytest.fixture
def small_mae(monkeypatch):
    """The JAX package's MAE configs narrowed to 2 blocks of C=128, where
    its fine-tuning reads them (the module's names and the fused path's
    import from models.vit_mae)."""
    gt = lambda **kw: jvit.MAEConfig(**{**GT_SMALL, **kw})
    am = lambda **kw: jvit.MAEConfig(**{**AM_SMALL, **kw})
    for mod in (jvit, jft):
        monkeypatch.setattr(mod, "mae_vit_small_config", gt)
        monkeypatch.setattr(mod, "audiomae_base_config", am)


def _port_kw(kind):
    if kind == "htsat":
        return dict(htsat_config=HTSATConfig(**TINY_HTSAT))
    return dict(mae_config=vit_mae.MAEConfig(**(GT_SMALL if kind == "gt" else AM_SMALL)))


def _jax_model(kind):
    feat = KINDS[kind][1]
    hc = JHTSATConfig(enable_tscam=False, **TINY_HTSAT) if kind == "htsat" else None
    return jft.EncoderClassifier(encoder_kind=kind, classes=2, feat_dim=feat, htsat_config=hc)


def _jax_init(kind, seed=0):
    model = _jax_model(kind)
    shape = (1,) + KINDS[kind][0]
    init = jax.jit(lambda: model.init({"params": jax.random.PRNGKey(seed),
                                       "dropout": jax.random.PRNGKey(1)}, jnp.zeros(shape)))
    return model, jax.tree.map(np.asarray, init())


def _port_model(kind, variables):
    model = ft.EncoderClassifier(kind, 2, "linear", KINDS[kind][1], **_port_kw(kind))
    model.load_state_dict(from_jax_classifier(variables, kind))
    return model


def _batch(kind, seed=3, B=4):
    r = np.random.default_rng(seed)
    x = r.standard_normal((B,) + KINDS[kind][0]).astype(np.float32)
    y = np.array([0, 1, 1, 0][:B], np.int32)
    valid = np.array([1, 1, 1, 0][:B], np.float32)  # a padded tail row
    cw = np.array([0.3, 0.7], np.float32)
    return x, y, valid, cw


def _tree_l2(tree):
    return sum(jnp.sum(p ** 2) for p in jax.tree.leaves(tree))


def _jax_loss_grads(kind, model, variables, x, y, valid, cw, fused):
    """The loss_fn of the JAX finetune_classifier (:376-386) on its fused
    route (interpret mode) or its flax route, and jax.grad of it."""
    bs = variables.get("batch_stats", {})

    def head(hp, h):
        return h @ hp["fc"]["kernel"] + hp["fc"]["bias"]

    def loss_fn(params):
        if fused and kind == "htsat":
            from heart_murmur_detection_tpu.models.htsat_train_fused import htsat_encode_train

            cfg = JHTSATConfig(enable_tscam=False, **TINY_HTSAT)
            h, _ = htsat_encode_train({"params": params["encoder"], "batch_stats": bs["encoder"]},
                                      x, jax.random.PRNGKey(2), cfg=cfg, interpret=True)
            logits = head(params["head"], h)
        elif fused:
            from heart_murmur_detection_tpu.models import mae_train_fused as jmf

            if kind == "gt":
                h = jmf.gt_backbone_train_fused(params["encoder"]["mae"], x,
                                                jvit.mae_vit_small_config(), interpret=True)
            else:
                h = jmf.audiomae_backbone_train_fused(params["encoder"], x,
                                                      jvit.audiomae_base_config(), interpret=True)
            logits = head(params["head"], h)
        elif kind == "htsat":
            logits, _ = model.apply({"params": params, "batch_stats": bs}, x, train=True,
                                    rngs={"dropout": jax.random.PRNGKey(2)},
                                    mutable=["batch_stats"])
        else:
            logits = model.apply({"params": params}, x, train=True,
                                 rngs={"dropout": jax.random.PRNGKey(2)})
        logits = logits + 1e-10
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, y)
        w = cw[y] * valid
        loss = (ce * w).sum() / jnp.maximum(w.sum(), 1e-12)
        return loss + L2 * _tree_l2(params["head"]) + 0.2 * L2 * _tree_l2(params["encoder"])

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    return float(loss), from_jax_classifier({"params": jax.device_get(g)}, kind)


def _port_loss_grads(model, x, y, valid, cw, impl):
    names = [n for n, _ in model.named_parameters()]
    loss, _ = ft.ft_loss(model, torch.from_numpy(x), torch.from_numpy(y).long(),
                         torch.from_numpy(valid), torch.from_numpy(cw), None, torch.float32,
                         impl, L2)
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return float(loss.detach()), dict(zip(names, grads))


@pytest.mark.parametrize("kind", list(KINDS))
def test_one_step_loss_and_gradients_match_jax_float32(kind, small_mae):
    model, v = _jax_init(kind)
    x, y, valid, cw = _batch(kind)
    port = _port_model(kind, v)
    for jax_fused in (True, False):
        lj, gj = _jax_loss_grads(kind, model, v, x, y, valid, cw, jax_fused)
        for impl in ("autograd", "kernel"):  # torch autograd; the kernels' plain versions
            lp, gp = _port_loss_grads(port, x, y, valid, cw, impl)
            tag = f"{kind} jax_fused={jax_fused} impl={impl}"
            assert abs(lp - lj) <= TOL * abs(lj), (tag, lp, lj)
            assert set(gp) == set(gj), tag
            for k, want in gj.items():
                want = want.numpy()
                err = np.abs(gp[k].numpy() - want).max()
                assert err <= TOL * max(1.0, np.abs(want).max()), (tag, k, err)


def _clf_data(kind, n, seed):
    r = np.random.default_rng(seed)
    y = r.integers(0, 2, n).astype(np.int32)
    x = r.random((n,) + KINDS[kind][0]).astype(np.float32)
    x += 0.8 * y[:, None, None]  # separable
    return x, y


@pytest.mark.parametrize("kind", list(KINDS))
def test_three_epochs_match_jax(kind, small_mae):
    """The same permutations, init and float32 steps: the same best epoch
    and valid AUROC (to 1e-3) after 3 epochs, the flax route on the JAX
    side."""
    x, y = _clf_data(kind, 32, seed=5)
    kw = dict(n_cls=2, feat_dim=KINDS[kind][1], lr=1e-3, epochs=3, batch_size=8, seed=0,
              l2_strength=L2)
    hc = JHTSATConfig(enable_tscam=False, **TINY_HTSAT) if kind == "htsat" else None
    jres = jft.finetune_classifier(x[:16], y[:16], x[16:24], y[16:24], x[24:], y[24:],
                                   encoder_kind=kind, htsat_config=hc, fused_train=False, **kw)
    _, v = _jax_init(kind, seed=0)
    aucs = []
    pres = ft.finetune_classifier(x[:16], y[:16], x[16:24], y[16:24], x[24:], y[24:],
                                  encoder_kind=kind, init_state=from_jax_classifier(v, kind),
                                  device="cpu", on_epoch=lambda e, a: aucs.append(a),
                                  **_port_kw(kind), **kw)
    assert len(aucs) == 3
    assert pres.best_epoch == jres.best_epoch
    assert abs(pres.valid_auc - jres.valid_auc) <= 1e-3
    assert abs(pres.test_auc - jres.test_auc) <= 1e-3
    assert np.isfinite(pres.test_auc)


def test_freeze_all_keeps_the_encoder():
    x, y = _clf_data("htsat", 24, seed=1)
    init = ft.EncoderClassifier("htsat", 2, "linear", 128, **_port_kw("htsat"),
                                generator=torch.Generator().manual_seed(0)).state_dict()
    res = ft.finetune_classifier(x[:16], y[:16], x[16:20], y[16:20], x[20:], y[20:],
                                 encoder_kind="htsat", feat_dim=128, epochs=2, batch_size=8,
                                 freeze_encoder="all", seed=0, device="cpu",
                                 **_port_kw("htsat"))
    model = ft.EncoderClassifier("htsat", 2, "linear", 128, **_port_kw("htsat"))
    for name, _ in model.named_parameters():
        if name.startswith("encoder."):
            assert torch.equal(res.state_dict[name], init[name]), name
    assert not torch.equal(res.state_dict["head.fc.weight"], init["head.fc.weight"])


def _jax_leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _jax_leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _mask_tree(tree, pred, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _mask_tree(v, pred, prefix + (k,))
        else:
            out[k] = np.full(np.shape(v), 1.0 if pred(prefix + (k,)) else 0.0, np.float32)
    return out


@pytest.mark.parametrize("mode", ["none", "all", "early"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_freeze_mask_is_the_image_of_the_jax_predicate(kind, mode, small_mae):
    """The port's trainable parameters are exactly the JAX predicate's
    trainable leaves under from_jax_classifier's name map."""
    _, v = _jax_init(kind)
    jpred = jax_freeze_mask_fn(mode)
    marks = from_jax_classifier({"params": _mask_tree(v["params"], jpred)}, kind)
    want = {k for k, t in marks.items() if bool((t == 1.0).all())}
    assert all(bool((t == 1.0).all()) or bool((t == 0.0).all()) for t in marks.values())
    model = _port_model(kind, v)
    pred = freeze_mask_fn(mode, kind)
    got = {n for n, _ in model.named_parameters() if pred(n)}
    assert {n for n, _ in model.named_parameters()} == set(marks)
    assert got == want
    if mode == "early" and kind == "htsat":
        assert "encoder.bn0.weight" not in got and "encoder.patch_embed.proj.weight" in got


def test_freeze_mask_full_width_htsat_early():
    """At the operaCT width (depths 2/2/6/2), 'early' freezes what the
    reference's name match freezes: bn0 only (the final norm, patch embed,
    stages 0-2 and, through the '_blocks_0' / '_blocks_1' names, stage 3's
    blocks stay trainable)."""
    model = ft.EncoderClassifier("htsat", 2, "linear", 768)
    pred = freeze_mask_fn("early", "htsat")
    frozen = {n for n, _ in model.named_parameters() if not pred(n)}
    assert frozen == {"encoder.bn0.weight", "encoder.bn0.bias"}


def _classifier_roundtrip(kind, v):
    sd = {k: t.numpy() for k, t in from_jax_classifier(v, kind).items()}
    enc = {k[len("encoder."):]: a for k, a in sd.items() if k.startswith("encoder.")}
    if kind == "htsat":
        params, stats = jconvert.convert_htsat(enc)
        back = {"params": {"encoder": params}, "batch_stats": {"encoder": stats}}
    elif kind == "gt":
        back = {"params": {"encoder": {"mae": jconvert.convert_mae(enc, depth=2)["params"]}}}
        # the JAX converter carries the mask_token only with the decoder
        back["params"]["encoder"]["mae"]["mask_token"] = enc["mask_token"]
    else:
        back = {"params": {"encoder": jconvert.convert_audiomae_backbone(enc, depth=2)["params"]}}
    back["params"]["head"] = {"fc": {"kernel": sd["head.fc.weight"].T, "bias": sd["head.fc.bias"]}}
    return back


@pytest.mark.parametrize("kind", list(KINDS))
def test_classifier_conversion_round_trip_exact(kind, small_mae, monkeypatch):
    """from_jax_classifier -> the JAX package's converters gives back the
    same flax tree, leaf for leaf, and the port's classifier loads it
    strictly (the JAX HTS-AT converter walks TINY_HTSAT's depths)."""
    monkeypatch.setattr(jconvert, "_HTSAT_DEPTHS", TINY_HTSAT["depths"])
    _, v = _jax_init(kind)
    back = _classifier_roundtrip(kind, v)
    want = dict(_jax_leaf_paths(v["params"]))
    got = dict(_jax_leaf_paths(back["params"]))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=str(k))
    if kind == "htsat":
        for k, a in _jax_leaf_paths(v["batch_stats"]):
            np.testing.assert_array_equal(dict(_jax_leaf_paths(back["batch_stats"]))[k], a)
    _port_model(kind, v)  # strict load


def _jax_stripe_draws(key, dim, drop_width, num):
    """The draws of the JAX _drop_stripes (its key splits, replayed)."""
    starts, widths = [], []
    for _ in range(num):
        kw, kb, key = jax.random.split(key, 3)
        width = jax.random.randint(kw, (), 0, drop_width)
        bgn = jax.random.randint(kb, (), 0, jnp.maximum(dim - width, 1))
        starts.append(int(bgn))
        widths.append(int(width))
    return torch.tensor([starts]), torch.tensor([widths])


@pytest.mark.parametrize("seed", range(6))
def test_drop_stripes_at_matches_the_jax_mask(seed):
    """drop_stripes_at on the JAX draws zeroes exactly the JAX stripes."""
    T, F, tdw, fdw = 60, 24, 40, 8
    x = np.random.default_rng(seed).random((T, F)).astype(np.float32) + 0.5
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaug.spec_augment(key, jnp.asarray(x), tdw, 2, fdw, 2))
    kt, kf = jax.random.split(key)
    got = augment.drop_stripes_at(torch.from_numpy(x)[None], _jax_stripe_draws(kt, T, tdw, 2),
                                  _jax_stripe_draws(kf, F, fdw, 2))[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_spec_augment_draw_ranges():
    """Widths ~ U{0..drop_width-1}, starts ~ U{0..dim-width-1}: every value
    in range, every width drawn, and the stripes of a generator repeat."""
    B, T, F = 4000, 60, 24
    gen = torch.Generator().manual_seed(0)
    (ts, tw), (fs, fw) = augment.spec_augment_draw(gen, B, T, F, 40, 2, 8, 3)
    assert ts.shape == tw.shape == (B, 2) and fs.shape == fw.shape == (B, 3)
    for s, w, dim, dw in ((ts, tw, T, 40), (fs, fw, F, 8)):
        assert int(w.min()) == 0 and int(w.max()) == dw - 1
        assert set(w.flatten().tolist()) == set(range(dw))
        assert bool((s >= 0).all()) and bool((s + w <= dim).all())
        assert bool(((s <= dim - w - 1) | (dim - w <= 1)).all())
    again = augment.spec_augment_draw(torch.Generator().manual_seed(0), B, T, F, 40, 2, 8, 3)
    assert torch.equal(again[0][0], ts) and torch.equal(again[1][1], fw)
    x = torch.ones(3, T, F)
    y = augment.spec_augment(x, torch.Generator().manual_seed(1), 40, 2, 8, 2)
    assert y.shape == x.shape and 0 < float((y == 0).float().mean()) < 1
    (_, w0), _ = augment.spec_augment_draw(None, 5, T, F, 0, 2, 8, 2)
    assert w0.shape == (5, 0)


def test_early_stopping_matches_the_jax_helper():
    r = np.random.default_rng(0)
    for mode, delta, patience in (("max", 1e-3, 3), ("min", 1e-2, 2), ("max", 0.0, 1),
                                  ("max", 1e-3, None)):
        a, b = ck.EarlyStopping(mode, delta, patience), jck.EarlyStopping(mode, delta, patience)
        vals = np.round(r.random(60), 2)
        for v in vals:
            assert a.step(v) == b.step(v)
    with pytest.raises(ValueError):
        ck.EarlyStopping("mean")


def test_find_best_ckpt_and_load_params(tmp_path):
    for i, auc in enumerate((0.61, 0.83, 0.7)):
        ck.save_params(str(tmp_path / f"ft_a-epoch={i:02d}-valid_auc={auc:.2f}.pt"),
                       {"w": torch.full((2,), float(i))})
    (tmp_path / "other-valid_auc=0.99.txt").write_text("")
    for mode in ("max", "min"):
        got = ck.find_best_ckpt(str(tmp_path), "ft_a-*.pt", mode=mode)
        assert got == jck.find_best_ckpt(str(tmp_path), "ft_a-*.pt", mode=mode)
    best = ck.find_best_ckpt(str(tmp_path), "ft_a-*.pt")
    assert best.endswith("valid_auc=0.83.pt")
    assert torch.equal(ck.load_params(best)["w"], torch.ones(2))
    assert ck.find_best_ckpt(str(tmp_path), "none-*.pt") is None


def test_unported_encoders_and_multi_device_raise(narrow_zoo):
    """Every encoder kind of the JAX classifier builds (efficientnet, clap,
    clap2023 and hear since the zoo's port); multi-device fine-tuning still
    raises, and an unknown kind is a ValueError."""
    x, y = _clf_data("htsat", 8, seed=0)
    for kind in ("efficientnet", "clap", "clap2023", "hear"):
        assert ft.EncoderClassifier(kind, 2, feat_dim=NEW_KINDS[kind][1]).encoder_kind == kind
    with pytest.raises(ValueError, match="resnet"):
        ft.finetune_classifier(x, y, x, y, encoder_kind="resnet", device="cpu")
    for kw in ({"mesh": object()}, {"param_sharding": "fsdp"}):
        with pytest.raises(NotImplementedError, match="slice 6"):
            ft.finetune_classifier(x, y, x, y, encoder_kind="htsat", device="cpu", **kw)
    with pytest.raises(ValueError):
        ft.EncoderClassifier("resnet", 2)


def test_train_impl_routes():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert ft.train_impl(torch.bfloat16, None, cuda) == "kernel"
    assert ft.train_impl(torch.bfloat16, None, cpu) == "plain"
    assert ft.train_impl(None, None, cuda) == "autograd"
    assert ft.train_impl(None, True, cpu) == "kernel"
    assert ft.train_impl(torch.bfloat16, False, cuda) == "plain"


def test_jax_and_port_ckpt_names_agree():
    kw = dict(head="linear", pretrain="operaCT", batch_size=64, lr=1e-4, epochs=64,
              l2_strength=1e-5, seed=3)
    for freeze, loss, tail in (("none", "unweighted", ""), ("early", "weighted", "_early_weighted")):
        assert ft.ckpt_name(**kw, freeze_encoder=freeze, loss=loss) == \
            "finetuning_linear_operaCT_64_0.0001_64_1e-05_3" + tail


def _circor_corpus(root):
    """A CirCor-layout corpus at 4 kHz: 12 patients, one 2-7.5 s clip each,
    murmur Present (a 150 Hz tone), Absent or Unknown; six train, three
    validation and three test patients, every split with all three classes."""
    from heart_murmur_detection_tpu_torch.utils.audio_io import write_wav

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


def test_cli_finetune_on_cpu(tmp_path, monkeypatch, capsys):
    """cli.finetune on a processed CirCor task: the first-window mel cache,
    two seeds of a 2-epoch fine-tune (SpecAugment on) on a narrow HTS-AT put
    in place of the full width, the JAX CLI's seed and five-seed lines, and
    one best checkpoint a seed under the JAX name stem."""
    from heart_murmur_detection_tpu_torch.cli import finetune as cli_finetune
    from heart_murmur_detection_tpu_torch.data.processors import circor

    _circor_corpus(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    os.makedirs("feature/circor_eval")
    circor.read_data(feature_dir="feature/circor_eval/")
    narrow = HTSATConfig(**{**TINY_HTSAT, "mel_bins": 64, "embed_dim": 96})  # 768 features
    monkeypatch.setattr(ft, "HTSATConfig", lambda: narrow)
    argv = ["task=circor_murmurs", "pretrain=operaCT", "random_init=True", "n_run=2",
            "epochs=2", "spec_augment=True", "device=cpu"]
    ((s0, s1),) = cli_finetune.main(argv)
    assert np.isfinite([s0, s1]).all()
    out = capsys.readouterr().out
    assert "seed 1: test_auc" in out
    assert "Five times mean task circor_murmurs finetuning from operaCT results: auc mean" in out
    cache = np.load("feature/circor_eval/spectrogram_pad8.npy")
    assert cache.shape == (12, 256, 64)
    ckpts = os.listdir("cks/finetune/circor_murmurs")
    assert len(ckpts) == 2 and all(
        c.startswith("finetuning_linear_operaCT_64_0.0001_2_1e-05_") and c.endswith(".pt")
        for c in ckpts)
    model = ft.EncoderClassifier("htsat", 3, "linear", 768, htsat_config=narrow)
    model.load_state_dict(ck.load_params(os.path.join("cks/finetune/circor_murmurs", ckpts[0])))


@pytest.mark.parametrize("argv,exc,match", [
    # the config's default pretrain, operaCE, wants its checkpoint
    (["task=circor_murmurs"], FileNotFoundError, "encoder-operaCE.ckpt"),
    (["task=circor_murmurs", "pretrain=operaCT", "dp=2"], NotImplementedError, "slice 6"),
    # HeAR (and CLAP) want converted weights or random_init
    (["task=circor_murmurs", "pretrain=hear"], FileNotFoundError, "ckpt_path"),
])
def test_cli_finetune_refusals(argv, exc, match, tmp_path, monkeypatch):
    from heart_murmur_detection_tpu_torch.cli import finetune as cli_finetune

    monkeypatch.chdir(tmp_path)
    d = tmp_path / "feature" / "circor_eval"
    d.mkdir(parents=True)
    np.save(d / "murmurs.npy", np.array([0, 1, 0, 1]))
    np.save(d / "train_test_split.npy", np.array(["train", "val", "test", "train"]))
    with pytest.raises(exc, match=match):
        cli_finetune.main(argv + ["device=cpu"])


# ---------------------------------------------------------------------------
# the rest of the zoo: efficientnet, clap, clap2023, hear
# ---------------------------------------------------------------------------

# (input shape of a clip, feature width): the EfficientNet on (96, 64) mels;
# CLAP on 0.5 s at 44.1 kHz (69 hops, the Cnn14's six pools reach one row);
# HeAR on a 2-s clip at 16 kHz at tests/test_torch_hear.py's narrow width
NEW_KINDS = {"efficientnet": ((96, 64), 1280), "clap": ((22080,), 1024),
             "clap2023": ((22080,), 1024), "hear": ((32000,), 64)}
# the CLAP-2023 HTS-AT narrowed (over CLAP's 64 mel bins) and HeAR's narrow tower
CLAP_HTSAT = dict(spec_size=128, patch_size=4, embed_dim=16, depths=(1, 1, 1, 1),
                  num_heads=(2, 2, 2, 2), window_size=2, drop_path_rate=0.0)
HEAR_WAVE = dict(image_size=(192, 128), patch_size=16, hidden=64, depth=1, heads=2,
                 mlp_ratio=4.0, pooled_dim=8)


@pytest.fixture
def narrow_zoo(monkeypatch):
    """Both packages' CLAP-2023 HTS-AT and HeAR narrowed where their
    classifiers build them, and every random draw of the comparison off:
    the EfficientNet's drop-connect and the CLAP projection's dropout (the
    JAX modules subclassed with a zero rate; the JAX package is not
    edited)."""
    import functools

    from heart_murmur_detection_tpu.models import clap as jclap
    from heart_murmur_detection_tpu.models import hear as jhear
    from heart_murmur_detection_tpu_torch.models import clap, hear

    class NoDropProjection(jclap.Projection):
        p: float = 0.0

    class NarrowHeAR(jhear.HeAREncoder):
        config: jhear.HeARConfig = jhear.HeARConfig(**HEAR_WAVE)

    monkeypatch.setattr(jclap, "Projection", NoDropProjection)
    monkeypatch.setattr(jclap, "HTSATConfig", lambda **kw: JHTSATConfig(**{**CLAP_HTSAT, **kw}))
    monkeypatch.setattr(jhear, "HeAREncoder", NarrowHeAR)
    monkeypatch.setattr(jft, "ColaEfficientNetEncoder",
                        functools.partial(jft.ColaEfficientNetEncoder, drop_connect_rate=0.0))
    real = clap.CLAPConfig
    monkeypatch.setattr(clap, "CLAPConfig", lambda **kw: real(**{**kw, "proj_dropout": 0.0}))
    monkeypatch.setattr(clap, "HTSATConfig", lambda **kw: HTSATConfig(**{**CLAP_HTSAT, **kw}))
    real_hear = hear.HeARConfig
    monkeypatch.setattr(hear, "HeARConfig", lambda: real_hear(**HEAR_WAVE))


_NEW_INITS = {}


def _new_jax(kind):
    """The JAX classifier of a new kind and its jitted init (numpy), made once
    a kind (under narrow_zoo's patches, which every caller holds)."""
    jmodel = jft.EncoderClassifier(encoder_kind=kind, classes=2, feat_dim=NEW_KINDS[kind][1])
    if kind not in _NEW_INITS:
        _NEW_INITS[kind] = jax.tree.map(np.asarray, jax.device_get(jax.jit(lambda: jmodel.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
            jnp.zeros((1,) + NEW_KINDS[kind][0])))()))
    return jmodel, _NEW_INITS[kind]


def _new_port(kind, v):
    model = ft.EncoderClassifier(kind, 2, "linear", NEW_KINDS[kind][1])
    if kind == "efficientnet":
        for blk in model.encoder.efficientnet._blocks:
            blk.drop = 0.0
    model.load_state_dict(from_jax_classifier(v, kind))
    return model


def _new_batch(kind, B=4):
    r = np.random.default_rng(11)
    x = r.standard_normal((B,) + NEW_KINDS[kind][0]).astype(np.float32)
    if kind != "efficientnet":
        x *= 0.1  # waveforms
    y = np.array([0, 1, 1, 0][:B], np.int32)
    valid = np.array([1, 1, 1, 0][:B], np.float32)
    return x, y, valid, np.array([0.3, 0.7], np.float32)


def _named(model, stats):
    """A models/bn.py stats dict keyed by each BatchNorm's name in model."""
    names = {m: n for n, m in model.named_modules()}
    return {names[bn]: v for bn, v in stats.items()}


def _port_grads_f64(kind, v, x, y, valid, cw):
    """The port's step in float64 (the exact reference for a leaf flax's
    float32 misses): gradient leaves by name, as numpy."""
    port = _new_port(kind, v).double()
    loss, _ = ft.ft_loss(port, torch.from_numpy(x).double(), torch.from_numpy(y).long(),
                         torch.from_numpy(valid).double(), torch.from_numpy(cw).double(), None,
                         torch.float32, "autograd", L2)
    params = [p for _, p in port.named_parameters()]
    return {n: g.numpy() for (n, _), g in zip(port.named_parameters(),
                                              torch.autograd.grad(loss, params))}


@pytest.mark.parametrize("kind", list(NEW_KINDS))
def test_one_step_new_kinds_match_jax_float32(kind, narrow_zoo):
    """One fine-tuning step's loss and every gradient leaf against the JAX
    finetune_classifier's loss_fn on its flax route (train mode: the
    BatchNorms on the batch statistics, their new running statistics
    compared too), in float32: the EfficientNet at full width, the Cnn14 at
    full width, the CLAP-2023 HTS-AT and HeAR narrowed.

    flax forms each BatchNorm's batch variance as mean(x^2) - mean(x)^2,
    which loses digits on the Cnn14's bn0 over dB log-mels: on this batch
    the JAX package's gradient leaves stand up to 1.4e-3 of their scale
    from the same step in float64, the port's (which forms the variance as
    mean((x - mean)^2)) within 1e-6. A leaf over the 2e-4 class therefore
    passes only if the port is within 2e-4 of the float64 step and no
    farther from flax than flax is from float64."""
    jmodel, v = _new_jax(kind)
    x, y, valid, cw = _new_batch(kind)
    has_bn = bool(v.get("batch_stats"))

    def loss_fn(params):
        vin = {"params": params, **({"batch_stats": v["batch_stats"]} if has_bn else {})}
        out = jmodel.apply(vin, x, train=True, rngs={"dropout": jax.random.PRNGKey(2)},
                           mutable=["batch_stats"] if has_bn else False)
        logits, new = out if has_bn else (out, {})
        ce = optax.softmax_cross_entropy_with_integer_labels(logits + 1e-10, y)
        w = cw[y] * valid
        loss = (ce * w).sum() / jnp.maximum(w.sum(), 1e-12)
        loss = loss + L2 * _tree_l2(params["head"]) + 0.2 * L2 * _tree_l2(params["encoder"])
        return loss, new

    (lj, new), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    gj = from_jax_classifier({"params": jax.device_get(g)}, kind)
    port = _new_port(kind, v)
    names = [n for n, _ in port.named_parameters()]
    loss, stats = ft.ft_loss(port, torch.from_numpy(x), torch.from_numpy(y).long(),
                             torch.from_numpy(valid), torch.from_numpy(cw), None, torch.float32,
                             "autograd", L2)
    gp = dict(zip(names, torch.autograd.grad(loss, [p for _, p in port.named_parameters()])))
    assert abs(float(loss.detach()) - float(lj)) <= TOL * abs(float(lj)), (kind, float(loss), lj)
    assert set(gp) == set(gj), kind
    exact = None
    for k, want in gj.items():
        want = want.numpy()
        scale = TOL * max(1.0, np.abs(want).max())
        err = np.abs(gp[k].numpy() - want).max()
        if err <= scale:
            continue
        # flax's fast variance (see the docstring): held to the float64 step
        if exact is None:
            exact = _port_grads_f64(kind, v, x, y, valid, cw)
        e = exact[k]
        assert np.abs(gp[k].numpy() - e).max() <= scale, (kind, k, err)
        assert err <= np.abs(want - e).max() + scale, (kind, k, err)
    if has_bn:
        want = from_jax_classifier({"params": v["params"], **jax.device_get(new)}, kind)
        got = _named(port, stats)
        assert len(got) == (49 if kind == "efficientnet" else 13 if kind == "clap" else 1)
        for name, (mean, var) in got.items():
            for t, leaf in ((mean, "running_mean"), (var, "running_var")):
                w = want[f"{name}.{leaf}"].numpy()
                assert np.abs(t.numpy() - w).max() <= 1e-5 * max(1.0, np.abs(w).max()), name
    else:
        assert stats is None


@pytest.mark.parametrize("mode", ["none", "all", "early"])
@pytest.mark.parametrize("kind", list(NEW_KINDS))
def test_freeze_mask_new_kinds_is_the_image_of_the_jax_predicate(kind, mode, narrow_zoo):
    """The trainable set of the new kinds under from_jax_classifier's name
    map: the JAX predicate's trainable leaves (the EfficientNet's cnn1 and
    blocks 0-4, with '_blocks_1' matching blocks 10-15 too; the CLAP-2023
    HTS-AT's patch embed, stages 0-2 and tscam; HeAR's patch embed)."""
    _, v = _new_jax(kind)
    marks = from_jax_classifier({"params": _mask_tree(v["params"], jax_freeze_mask_fn(mode))},
                                kind)
    want = {k for k, t in marks.items() if bool((t == 1.0).all())}
    model = _new_port(kind, v)
    pred = freeze_mask_fn(mode, kind)
    assert {n for n, _ in model.named_parameters()} == set(marks)
    assert {n for n, _ in model.named_parameters() if pred(n)} == want


def test_cli_finetune_new_kinds_then_eval_ckpts_on_cpu(tmp_path, monkeypatch, capsys,
                                                       narrow_zoo):
    """cli.finetune on its config defaults (operaCE, random_init, one seed,
    one epoch), then cli.eval_ckpts re-tests the saved EfficientNet in
    float32; pretrain=null fine-tunes the random EfficientNet without a
    checkpoint; cli.finetune pretrain=clap2023 and pretrain=hear random_init
    fine-tune (narrowed) from their clap_audio_2023.npy / fbank_hear.npy
    caches."""
    from heart_murmur_detection_tpu_torch.cli import eval_ckpts as cli_eval
    from heart_murmur_detection_tpu_torch.cli import finetune as cli_finetune
    from heart_murmur_detection_tpu_torch.data.processors import circor

    _circor_corpus(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    os.makedirs("feature/circor_eval")
    circor.read_data(feature_dir="feature/circor_eval/")
    ((s,),) = cli_finetune.main(["task=circor_murmurs", "random_init=True", "n_run=1",
                                 "epochs=1", "device=cpu"])
    assert np.isfinite(s)
    (ck,) = os.listdir("cks/finetune/circor_murmurs")
    assert ck.startswith("finetuning_linear_operaCE_64_0.0001_1_1e-05_0_weighted")
    ((r,),) = cli_eval.main(["task=circor_murmurs", "head_only=False", "loss=weighted",
                             "batch_size=64", "epochs=1", "n_run=1", "device=cpu"])
    assert np.isfinite(r)
    # pretrain=null (yaml's None): the random EfficientNet, no checkpoint
    ((s,),) = cli_finetune.main(["task=circor_murmurs", "pretrain=null", "n_run=1", "epochs=1",
                                 "device=cpu"])
    assert np.isfinite(s)
    assert any(c.startswith("finetuning_linear_null_64") for c in
               os.listdir("cks/finetune/circor_murmurs"))
    for pretrain, cache, shape in (("clap2023", "clap_audio_2023.npy", (12, 308480)),
                                   ("hear", "fbank_hear.npy", (12, 32000))):
        ((s,),) = cli_finetune.main([f"task=circor_murmurs", f"pretrain={pretrain}",
                                     "random_init=True", "n_run=1", "epochs=1", "device=cpu"])
        assert np.isfinite(s), pretrain
        assert np.load(os.path.join("feature/circor_eval", cache)).shape == shape
