"""The port's optimizer utilities (train/optim.py) against the JAX package's
optax transformations (train/optim.py): the layer ids of every parameter
of the port's MAE ViT (decoder included) against the JAX ids of the
matching flax paths, and three steps of AdamW with layer-wise lr decay and
of LARS from the same weights (a JAX init carried over by from_jax_mae)
under the same fixed gradients: the same parameters to rtol 1e-6 (AdamW
against the optax chain run in float64, see its test)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from heart_murmur_detection_tpu.models import vit_mae as jvit
from heart_murmur_detection_tpu.train import optim as joptim
from heart_murmur_detection_tpu_torch.extract import convert
from heart_murmur_detection_tpu_torch.models import vit_mae
from heart_murmur_detection_tpu_torch.train import optim

SMALL = dict(img_size=(32, 16), patch_size=4, embed_dim=64, depth=3, num_heads=2,
             decoder_embed_dim=32, decoder_depth=2, decoder_num_heads=2)
RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(scope="module")
def mae():
    """(flax params (numpy), the port's MAE with its decoder on them)."""
    model = jvit.MaskedAutoencoderViT(jvit.MAEConfig(**SMALL))
    v = jax.device_get(jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, 16))))())
    return v["params"]


def _port(params):
    model = vit_mae.MaskedAutoencoderViT(vit_mae.MAEConfig(**SMALL), decoder=True)
    model.load_state_dict(convert.from_jax_mae({"params": params}, decoder=True))
    return model


def _flax_top(name: str) -> str:
    """The flax top-level name of a port parameter name."""
    parts = name.split(".")
    if parts[0] in ("blocks", "decoder_blocks"):
        return f"{parts[0]}_{parts[1]}"
    return "patch_embed_proj" if parts[0] == "patch_embed" else parts[0]


def test_vit_layer_id_matches_jax(mae):
    model = _port(mae)
    L = SMALL["depth"] + 1
    names = [n for n, _ in model.named_parameters()]
    assert {_flax_top(n) for n in names} == set(mae)
    ids = {n: optim.vit_layer_id(n, L) for n in names}
    for n in names:
        assert ids[n] == joptim.vit_layer_id([_flax_top(n)], L), n
    assert set(ids.values()) == set(range(L + 1))
    assert ids["cls_token"] == 0 and ids["blocks.2.norm1.weight"] == 3
    assert ids["decoder_blocks.0.norm1.weight"] == ids["mask_token"] == L


def _grads(params, seed):
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (0.1 * r.standard_normal(p.shape)).astype(np.float32), params)


def _jax_steps(jax_opt, params, grads, dtype):
    """Three optax steps in `dtype` -> the parameters as a port state_dict."""
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)
    params = cast(params)
    state = jax_opt.init(params)
    step = jax.jit(lambda p, g, s: jax_opt.update(g, s, p))
    for g in grads:
        upd, state = step(params, cast(g), state)
        params = optax.apply_updates(params, upd)
    host = jax.tree.map(lambda a: np.asarray(a, np.float64), jax.device_get(params))
    return {k: t.numpy() for k, t in convert.from_jax_mae({"params": host}, decoder=True).items()}


def _run(mae, jax_opt_fn, torch_opt_fn, f64=False):
    """Three steps from the same weights under the same gradients: (the
    port's parameters, the JAX package's in float32, and in float64 with
    f64 (None otherwise))."""
    grads = [_grads(mae, s) for s in range(3)]
    want = _jax_steps(jax_opt_fn(mae), mae, grads, jnp.float32)
    want64 = None
    if f64:
        with jax.enable_x64(True):
            want64 = _jax_steps(jax_opt_fn(mae), mae, grads, jnp.float64)

    model = _port(mae)
    opt = torch_opt_fn(model)
    named = dict(model.named_parameters())
    for g in grads:
        gsd = convert.from_jax_mae({"params": g}, decoder=True)
        for k, p in named.items():
            p.grad = gsd[k].clone()
        opt.step()
    return {k: p.detach().numpy() for k, p in named.items()}, want, want64


def test_adamw_lrd_three_steps_match_optax(mae):
    """torch.optim.AdamW over the layer groups (the scale in each group's
    lr, 1-D parameters without decay) = scale_by_adam -> decayed weights ->
    layer scale -> -lr: rtol 1e-6 against the optax chain in float64. In
    float32 optax forms Adam's bias correction 1 - 0.999^t in float32 (a
    relative error of 1.3e-5 at t = 1; torch forms it in float64), which
    moves each update by up to ~1e-5 of lr: that run is held to rtol 1e-6
    plus 3e-5 lr."""
    kw = dict(lr=1e-2, layer_decay=0.6, weight_decay=0.3)
    got, want, want64 = _run(mae, lambda p: joptim.adamw_lrd(p, SMALL["depth"], **kw),
                             lambda m: optim.adamw_lrd(m, SMALL["depth"], **kw), f64=True)
    for k in got:
        np.testing.assert_allclose(got[k], want64[k], rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=3e-5 * kw["lr"], err_msg=k)
    groups = optim.layerwise_lr_decay(_port(mae), SMALL["depth"], 1.0, 0.5, 0.1)
    assert {(g["layer_id"], g["lr"], g["weight_decay"]) for g in groups} >= {
        (0, 0.5 ** 4, 0.1), (4, 1.0, 0.0), (2, 0.25, 0.1)}


def test_lars_three_steps_match_optax(mae):
    """Trust-ratio momentum for ndim > 1 (weight decay inside the ratio),
    plain momentum for 1-D parameters; a zero parameter takes ratio 1."""
    mae = dict(mae, mask_token=np.zeros_like(mae["mask_token"]))
    kw = dict(lr=0.5, momentum=0.8, weight_decay=0.05, trust_coefficient=0.01)
    got, want, _ = _run(mae, lambda p: joptim.lars(**kw),
                        lambda m: optim.LARS(m.parameters(), **kw))
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)
