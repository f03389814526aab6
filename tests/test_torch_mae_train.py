"""The port's MAE continued pretraining against the JAX package on the same
numpy inputs, weights and masking noise: the swin-v2-cr decoder block and
forward_decoder (float32, shifted and unshifted), the bf16 decoder against
mae_decoder_opt, the fused pretraining loss and every gradient leaf
(float32 and bf16), norm_pix_loss, a batch shorter than the config's image
(its own token count), the weight conversion of the whole tree, the
checkpoint loader, the MAE sampler, and three CP steps of the loop. Small
configs: C 128, 4 heads, depth 2, decoder 64 wide and 2 deep (so the shifted
block runs), img 32 x 16, patch 4."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.extract import convert as jconvert
from heart_murmur_detection_tpu.models import vit_mae as jvit
from heart_murmur_detection_tpu.models.mae_decoder_opt import decoder_forward_opt
from heart_murmur_detection_tpu.models.mae_train_fused import mae_train_loss_fused as jax_loss
from heart_murmur_detection_tpu.pretrain import data as jax_data
from heart_murmur_detection_tpu.pretrain import mae_training as jax_mae_training
from heart_murmur_detection_tpu_torch.cli import pretrain as cli_pretrain
from heart_murmur_detection_tpu_torch.extract import convert
from heart_murmur_detection_tpu_torch.models import mae_train_fused, vit_mae
from heart_murmur_detection_tpu_torch.models.mae_train_fused import mae_train_loss_fused
from heart_murmur_detection_tpu_torch.pretrain import data, mae_training


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the test run shares the cores among its xdist
    workers (see test_torch_swin.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TINY = dict(img_size=(32, 16), patch_size=4, embed_dim=128, depth=2, num_heads=4,
            decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=4)
ATOL, RTOL = 2e-4, 2e-3  # test_mae_train_fused.py's bar for every gradient leaf
COS_BAR = 0.99999  # bf16: the port's rounding points against the JAX function's
# bf16 end to end (2 encoder and 2 decoder blocks, the loss): the same
# rounding points summed in other orders by two frameworks; a leaf's cosine
# reads 0.999991 at the lowest (cls_token), the ROADMAP's bf16 gradient bar
GRAD_BAR = 0.9999
# a per-head constant added to every logit of a softmax row: its exact
# gradient is 0, so both packages give float noise there (~1e-9)
ZERO_GRAD = "attn.meta_mlp.fc2.bias"


def _cfgs(**kw):
    return jvit.MAEConfig(**TINY, **kw), vit_mae.MAEConfig(**TINY, **kw)


def _jinit(jcfg, seed=0):
    model = jvit.MaskedAutoencoderViT(jcfg)
    k = jax.random.PRNGKey(seed)
    v = jax.jit(lambda: model.init({"params": k, "masking": k},
                                   jnp.zeros((1,) + jcfg.img_size)))()
    return model, jax.device_get(v)


@pytest.fixture(scope="module")
def towers():
    """The JAX MAE and the port's, on the same weights (cls, mask token and
    the decoder's biases, taus and norms moved off their inits)."""
    jcfg, cfg = _cfgs()
    jmodel, v = _jinit(jcfg)
    r = np.random.default_rng(5)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05 * r.standard_normal(a.shape).astype(
        np.float32) * (np.ndim(a) < 2 or a.shape[0] == 1), v["params"])
    model = vit_mae.MaskedAutoencoderViT(cfg, decoder=True)
    model.load_state_dict(convert.from_jax_mae({"params": params}, decoder=True))
    return jmodel, params, model


def _noise(B, L, seed):
    return np.random.default_rng(seed).random((B, L)).astype(np.float32)


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i", [0, 1])  # block 1 is shifted (2, 0) with its -100 mask
def test_swin_v2cr_block_matches_flax(towers, i):
    jmodel, params, model = towers
    cfg = jmodel.config
    blk = jvit.SwinV2CRBlock(cfg.decoder_embed_dim, cfg.decoder_num_heads, feat_size=cfg.grid,
                             window=cfg.decoder_window,
                             shift=(0, 0) if i % 2 == 0 else cfg.decoder_shift)
    x = np.random.default_rng(i).standard_normal((2, 32, 64)).astype(np.float32)
    want = jax.jit(lambda p, a: blk.apply({"params": p}, a))(params[f"decoder_blocks_{i}"], x)
    with torch.no_grad():
        got = model.decoder_blocks[i](torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def _decoder_inputs(B=2, L=32, keep=9, seed=3):
    h = np.random.default_rng(seed).standard_normal((B, 1 + keep, 128)).astype(np.float32)
    ids_restore = np.argsort(np.argsort(_noise(B, L, seed), 1, kind="stable"), 1, kind="stable")
    return h, ids_restore


def test_forward_decoder_matches_flax(towers):
    jmodel, params, model = towers
    h, ids = _decoder_inputs()
    want = jax.jit(lambda p, a, r: jmodel.apply({"params": p}, a, r,
                                                method=jmodel.forward_decoder))(params, h, ids)
    with torch.no_grad():
        got = model.forward_decoder(torch.from_numpy(h), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_bf16_decoder_matches_decoder_opt(towers):
    """The bf16 decoder rounds where the JAX package's bf16 decoder
    (mae_decoder_opt) rounds."""
    jmodel, params, model = towers
    h, ids = _decoder_inputs()
    want = jax.jit(lambda p, a, r: decoder_forward_opt(p, a, r, jmodel.config,
                                                       mm_dtype=jnp.bfloat16))(params, h, ids)
    with torch.no_grad():
        got = model.forward_decoder(torch.from_numpy(h), torch.from_numpy(ids), torch.bfloat16)
    assert _cos(got.numpy(), np.asarray(want)) >= COS_BAR


# ---------------------------------------------------------------------------
# the fused pretraining loss and its gradients
# ---------------------------------------------------------------------------


def _grads(model, x, noise, mm, impl="plain"):
    model.zero_grad(set_to_none=True)
    loss = mae_train_loss_fused(model, torch.from_numpy(x), torch.from_numpy(noise), None, mm, impl)
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in model.named_parameters()}


def _jax_grads(jmodel, params, x, noise, mm):
    f = lambda p: jax_loss(jmodel, p, x, None, mm_dtype=mm, interpret=True, noise=noise,
                           decoder_opt=mm == jnp.bfloat16)
    loss, g = jax.jit(jax.value_and_grad(f))(params)
    return float(loss), convert.from_jax_mae({"params": jax.device_get(g)}, decoder=True)


@pytest.mark.parametrize("T", [32, 8])  # 8 frames: L = 8 patches, not the config's 32
def test_loss_and_gradients_match_jax_float32(towers, T):
    jmodel, params, model = towers
    x = np.random.default_rng(T).standard_normal((2, T, 16)).astype(np.float32)
    noise = _noise(2, (T // 4) * 4, T)
    loss, g = _grads(model, x, noise, torch.float32, "autograd")
    jl, jg = _jax_grads(jmodel, params, x, noise, jnp.float32)
    np.testing.assert_allclose(loss, jl, rtol=1e-4, atol=1e-5)
    assert set(g) == set(jg)
    for k, want in jg.items():
        np.testing.assert_allclose(g[k].numpy(), want.numpy(), atol=ATOL, rtol=RTOL, err_msg=k)
    # the strict float32 path is the plain flax model's loss
    with torch.no_grad():
        direct = model(torch.from_numpy(x), torch.from_numpy(noise))[0]
    np.testing.assert_allclose(float(direct), jl, rtol=1e-4, atol=1e-5)


def test_loss_and_gradients_match_jax_bf16(towers):
    """The bf16 flow (training blocks and the bf16 decoder) against the JAX
    fused bf16 step, each leaf by cosine."""
    jmodel, params, model = towers
    x = np.random.default_rng(9).standard_normal((2, 32, 16)).astype(np.float32)
    noise = _noise(2, 32, 9)
    loss, g = _grads(model, x, noise, torch.bfloat16)
    jl, jg = _jax_grads(jmodel, params, x, noise, jnp.bfloat16)
    np.testing.assert_allclose(loss, jl, rtol=1e-3)
    for k, want in jg.items():
        if k.endswith(ZERO_GRAD):
            assert max(g[k].abs().max(), want.abs().max()) < 1e-6, k
    low = {k: _cos(g[k].numpy(), want.numpy()) for k, want in jg.items()
           if not k.endswith(ZERO_GRAD)}
    assert min(low.values()) >= GRAD_BAR, sorted(low.items(), key=lambda kv: kv[1])[:3]


def test_norm_pix_loss_matches_jax():
    jcfg, cfg = _cfgs(norm_pix_loss=True)
    jmodel, v = _jinit(jcfg, seed=1)
    model = vit_mae.MaskedAutoencoderViT(cfg, decoder=True)
    model.load_state_dict(convert.from_jax_mae(v, decoder=True))
    x = np.random.default_rng(11).standard_normal((2, 32, 16)).astype(np.float32)
    noise = _noise(2, 32, 11)
    jl = jax.jit(lambda p: jax_loss(jmodel, p, x, None, interpret=True, noise=noise))(v["params"])
    with torch.no_grad():
        got = mae_train_loss_fused(model, torch.from_numpy(x), torch.from_numpy(noise),
                                   impl="autograd")
    np.testing.assert_allclose(float(got), float(jl), rtol=1e-4, atol=1e-5)


def test_masking_draws_the_batch_token_count():
    """Without noise the masking draws (B, L) from the generator with L from
    the batch: a 12-frame batch of a 32-frame config masks 12 patches."""
    _, cfg = _cfgs()
    model = vit_mae.MaskedAutoencoderViT(cfg, decoder=True)
    x = torch.randn(3, 12, 16)
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    with torch.no_grad():
        a = mae_train_loss_fused(model, x, generator=g1, impl="autograd")
        noise = torch.rand(3, 12, generator=g2)
        b = mae_train_loss_fused(model, x, noise, impl="autograd")
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def test_from_jax_mae_carries_the_whole_tree(towers):
    jmodel, params, model = towers
    sd = convert.from_jax_mae({"params": params}, decoder=True)
    assert any(k.startswith("decoder_blocks.1.attn.meta_mlp") for k in sd) and "mask_token" in sd
    back = jconvert.convert_mae({k: t.numpy() for k, t in sd.items()}, depth=2,
                                decoder_depth=2)["params"]
    jax.tree.map(np.testing.assert_array_equal, back, params)
    assert set(sd) == set(model.state_dict())


def test_load_mae_ckpt_loads_the_decoder_strictly(tmp_path, towers):
    _, params, model = towers
    sd = convert.from_jax_mae({"params": params}, decoder=True)
    full = {f"encoder.{k}": t for k, t in sd.items()}
    full["encoder.decoder_pos_embed"] = torch.zeros(1, 33, 64)  # not a weight here
    path = str(tmp_path / "mae.ckpt")
    torch.save({"state_dict": full}, path)
    fresh = vit_mae.MaskedAutoencoderViT(model.config, decoder=True)
    convert.load_mae_ckpt(path, fresh)
    for k, t in fresh.state_dict().items():
        assert torch.equal(t, sd[k]), k
    del full["encoder.decoder_blocks.1.attn.tau"]
    torch.save({"state_dict": full}, path)
    with pytest.raises(KeyError, match="lacks"):
        convert.load_mae_ckpt(path, fresh)
    # the encoder alone (extraction) still loads the same checkpoint
    convert.load_mae_ckpt(path, vit_mae.MaskedAutoencoderViT(model.config))


# ---------------------------------------------------------------------------
# the sampler and the loop
# ---------------------------------------------------------------------------


def synth_corpus(name, n_train, n_val, lo, hi, bins, max_len, module=data, seed=0):
    r = np.random.default_rng(seed)
    clips = [r.standard_normal((int(t), bins)).astype(np.float32)
             for t in r.integers(lo, hi, n_train + n_val)]
    return module.Corpus(name, clips[:n_train], clips[n_train:], max_len)


@pytest.mark.parametrize("method", ["audiomae", "mae"])
def test_mae_sampler_matches_jax(method):
    """Crop-or-pad items, drop_last, the weighted corpus draw and the
    validation batches, as the JAX MultiCorpusSampler gives them."""
    mk = lambda m: [synth_corpus("a", 21, 5, 20, 60, 16, 32, m, 1),
                    synth_corpus("b", 9, 5, 30, 40, 16, 48, m, 2)]
    ours = data.MultiCorpusSampler(mk(data), 4, method, seed=7)
    theirs = jax_data.MultiCorpusSampler(mk(jax_data), 4, method, seed=7)
    assert ours.drop_last and theirs.drop_last
    assert ours.steps_per_epoch == theirs.steps_per_epoch == 5
    for _ in range(8):
        (s1, x1), (s2, x2) = ours.next_batch(), theirs.next_batch()
        assert s1 == s2
        np.testing.assert_array_equal(x1, x2)
    v1, v2 = list(ours.val_batches()), list(theirs.val_batches())
    assert len(v1) == len(v2) == 2
    for (s1, x1), (s2, x2) in zip(v1, v2):
        assert s1 == s2
        np.testing.assert_array_equal(x1, x2)


def _jax_step_noises(seed, n, B, L):
    """The masking noise the JAX loop draws: its step key chain, one split
    a train step or an eval batch, uniform (B, L) from each key."""
    rng = jax.random.PRNGKey(seed + 1)
    out = []
    for _ in range(n):
        rng, k = jax.random.split(rng)
        out.append(np.asarray(jax.random.uniform(k, (B, L))))
    return out


def test_three_mae_cp_steps_match_jax(tmp_path, monkeypatch):
    """3 epochs of one step each (4 train clips, batch 4) and one eval batch
    each, strict float32, the JAX loop's masking noise fed to the port:
    per-epoch train and eval losses at rtol 1e-4, final parameters at
    rtol 1e-3."""
    jcfg, cfg = _cfgs(mask_ratio=0.7)
    eager_init = jvit.MaskedAutoencoderViT.init
    monkeypatch.setattr(jvit.MaskedAutoencoderViT, "init", lambda self, rngs, *a: jax.jit(
        lambda xs: eager_init(self, rngs, *xs))(a))
    corpus = lambda m: [synth_corpus("a", 4, 4, 20, 60, 16, 32, m, 3)]
    common = dict(title="tiny", data_source={"a": 32}, n_epoches=3, training_method="mae",
                  batch_size=4, seed=0, verbose=False)
    jv, jh, _ = jax_mae_training.mae_train_multiple_data(
        corpora=corpus(jax_data), config_override=jcfg, ckpt_root=str(tmp_path / "jax" / "cks"),
        log_dir=str(tmp_path / "jax" / "logs"), **common)
    noises = iter(_jax_step_noises(0, 6, 4, 32))
    monkeypatch.setattr(mae_train_fused, "masking_noise",
                        lambda B, L, gen, dev: torch.tensor(next(noises)))
    _, v0 = _jinit(jcfg)
    sd, h, _ = mae_training.mae_train_multiple_data(
        corpora=corpus(data), config_override=cfg, ckpt_root=str(tmp_path / "port" / "cks"),
        log_dir=str(tmp_path / "port" / "logs"), device="cpu",
        initial_state=convert.from_jax_mae(v0, decoder=True), **common)
    assert [e["epoch"] for e in h] == [0, 1, 2] and [e["steps"] for e in h] == [1, 1, 1]
    for a, b in zip(h, jh):
        np.testing.assert_allclose(a["train_loss"], b["train_loss"], rtol=1e-4)
        np.testing.assert_allclose(a["valid_loss"], b["valid_loss"], rtol=1e-4)
    want = convert.from_jax_mae(jax.tree.map(np.asarray, jv), decoder=True)
    init = convert.from_jax_mae(v0, decoder=True)
    for k, v in want.items():
        got, v = sd[k].numpy(), v.numpy()
        # leaves whose exact gradient is 0 (the key bias adds a per-query
        # constant to the logits, ZERO_GRAD a per-head one): Adam scales
        # float noise to +-lr steps in either package, held to Adam's bound
        noise_only = np.zeros(v.shape, bool)
        if k.endswith("attn.qkv.bias"):
            n = v.shape[0] // 3
            noise_only[n:2 * n] = True
        elif k.endswith(ZERO_GRAD):
            noise_only[:] = True
        step = np.abs(got - init[k].numpy())[noise_only]
        assert step.size == 0 or step.max() <= 3e-4 * (1 + 1e-6), k
        got, v = got[~noise_only], v[~noise_only]
        if v.size:
            np.testing.assert_allclose(got, v, rtol=1e-3, atol=1e-3 * np.abs(v).max() + 1e-7,
                                       err_msg=k)
    with open(tmp_path / "port" / "logs" / "combined" / "tiny" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 3 and "train0_loss" in rows[0] and "valid_loss" in rows[0]


def test_cli_runs_mae_on_the_cpu(tmp_path, monkeypatch):
    """method=mae through the CLI on a tiny corpus in the reference layout,
    with the towers narrowed (the config builders are patched)."""
    monkeypatch.chdir(tmp_path)
    d = tmp_path / "datasets" / "covid19-sounds"
    os.makedirs(d / "spec")
    r = np.random.default_rng(0)
    names = []
    for i in range(10):
        np.save(d / "spec" / f"{i}.npy", r.standard_normal((int(r.integers(40, 90)), 64)))
        names.append(str(d / "spec" / f"{i}"))
    np.save(d / "SSL_entireaudio_filenames_cough.npy", np.asarray(names))
    narrow = dict(embed_dim=128, depth=2, num_heads=2, decoder_embed_dim=64, decoder_depth=2,
                  decoder_num_heads=2)
    monkeypatch.setattr(mae_training, "mae_vit_small_config",
                        lambda **kw: vit_mae.mae_vit_small_config(**narrow, **kw))
    ((sd, hist, _),) = cli_pretrain.main(["method=mae", "covidcough=True", "batch_size=4",
                                          "epoches=1", "device=cpu", "title=t",
                                          "compute_dtype=bfloat16"])
    assert hist[0]["steps"] == 2 and np.isfinite(hist[0]["train_loss"])
    assert any(k.startswith("decoder_blocks.") for k in sd)


def _tiny_loop(tmp_path, **kw):
    _, cfg = _cfgs()
    args = dict(title="tiny", data_source={"a": 32}, training_method="mae", batch_size=4,
                seed=0, verbose=False, config_override=cfg, device="cpu",
                corpora=[synth_corpus("a", 4, 4, 20, 60, 16, 32, data, 3)],
                ckpt_root=str(tmp_path / "cks"), log_dir=str(tmp_path / "logs"))
    args.update(kw)
    return mae_training.mae_train_multiple_data(**args)


def test_audiomae_warm_start_loads_the_whole_model_strictly(tmp_path, towers):
    """pretrain='audiomae' loads a reference-style {"model": state_dict}
    into the whole MAE, the decoder included; a checkpoint without a decoder
    key is refused, and a missing file names its path."""
    _, params, _ = towers
    sd = convert.from_jax_mae({"params": params}, decoder=True)
    path = str(tmp_path / "pretrained.pth")
    torch.save({"model": {**sd, "pos_embed": torch.zeros(1, 33, 128)}}, path)
    got, hist, _ = _tiny_loop(tmp_path, n_epoches=0, pretrain="audiomae", ckpt_path=path)
    assert hist == [] and all(torch.equal(got[k], sd[k]) for k in sd)
    del sd["decoder_pred.bias"]
    torch.save({"model": sd}, path)
    with pytest.raises(KeyError, match="lacks"):
        _tiny_loop(tmp_path, n_epoches=0, pretrain="audiomae", ckpt_path=path)
    with pytest.raises(FileNotFoundError, match="nowhere.pth"):
        _tiny_loop(tmp_path, n_epoches=0, pretrain="audiomae",
                   ckpt_path=str(tmp_path / "nowhere.pth"))


def test_mae_checkpoints_after_five_epochs_and_resume(tmp_path):
    """Top-k files land on epoch 4 (every 5 epochs) under the JAX package's
    names with the reference's .ckpt suffix, load into the MAE by name;
    last.ckpt resumes the run."""
    sd, h, best = _tiny_loop(tmp_path, n_epoches=5)
    assert len(h) == 5 and best is not None and os.path.exists(best)
    assert os.path.basename(best).startswith("encoder-tiny-epoch=04--valid_acc=0.00-valid_loss=")
    model = vit_mae.MaskedAutoencoderViT(_cfgs()[1], decoder=True)
    convert.load_mae_ckpt(best, model)
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())
    sd2, h2, _ = _tiny_loop(tmp_path, n_epoches=6, resume=True)
    assert [e["epoch"] for e in h2] == [5]
