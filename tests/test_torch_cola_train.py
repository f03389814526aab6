"""models/htsat_train_fused.py of the port (cola_train_apply) against the JAX
cola_train_apply (Pallas train kernels in interpret mode) on the same numpy
weights and inputs: loss, every gradient leaf and the chained bn0 running
statistics, deterministic (dropout and DropPath off), in float32.
Weights and gradients go through extract/convert.py::from_jax."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu.models.cola import Cola as JaxCola
from heart_murmur_detection_tpu.models.cola import ColaConfig
from heart_murmur_detection_tpu.models.cola import cola_loss as jax_cola_loss
from heart_murmur_detection_tpu.models.htsat import HTSATConfig as JaxHTSATConfig
from heart_murmur_detection_tpu.models.htsat_train_fused import cola_train_apply as jax_apply
from heart_murmur_detection_tpu_torch.extract.convert import from_jax
from heart_murmur_detection_tpu_torch.models.cola import Cola, cola_loss
from heart_murmur_detection_tpu_torch.models.htsat import HTSATConfig
from heart_murmur_detection_tpu_torch.models.htsat_train_fused import cola_train_apply


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the test run shares the cores among its xdist
    workers (see test_torch_swin.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# test_htsat_train_fused.py's TINY: window 2, a shifted block in stage 0
TINY = dict(spec_size=64, patch_size=4, embed_dim=16, depths=(2, 1, 1, 1),
            num_heads=(2, 2, 2, 2), window_size=2, mel_bins=16, drop_path_rate=0.0)
# narrow, window 8: stage 0 with a shifted block through the train block,
# stage 3 (4x4, window 4) as the plain float32 block in both packages
NARROW8 = dict(spec_size=128, patch_size=4, embed_dim=16, depths=(2, 1, 1, 1),
               num_heads=(2, 2, 2, 2), window_size=8, mel_bins=32, drop_path_rate=0.0)
G_RTOL, G_ATOL = 5e-4, 5e-5  # test_htsat_train_fused.py's gradient bounds


def _jax_run(cfg_kw, T):
    cfg = JaxHTSATConfig(enable_tscam=False, **cfg_kw)
    model = JaxCola(ColaConfig(encoder="htsat", p=0.0), htsat=cfg)
    r = np.random.default_rng(0)
    x1 = r.standard_normal((2, T, cfg.mel_bins)).astype(np.float32)
    x2 = r.standard_normal((2, T, cfg.mel_bins)).astype(np.float32)
    init = jax.jit(lambda k: model.init(k, (jnp.asarray(x1), jnp.asarray(x2))))
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    bs = variables["batch_stats"]

    def loss_fn(p):
        (z1, z2), new_bs = jax_apply({"params": p, "batch_stats": bs}, (x1, x2),
                                     jax.random.PRNGKey(1), p_drop=0.0, cfg=cfg,
                                     deterministic=True, interpret=True)
        return jax_cola_loss(z1, z2)[0], new_bs

    (loss, new_bs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return variables, x1, x2, float(loss), jax.tree.map(np.asarray, new_bs), \
        jax.tree.map(np.asarray, grads)


def _port_run(cfg_kw, variables, x1, x2, impl):
    model = Cola(htsat=HTSATConfig(**cfg_kw))
    model.load_state_dict(from_jax(variables))
    (z1, z2), (mean, var) = cola_train_apply(
        model, torch.from_numpy(x1), torch.from_numpy(x2), None, p_drop=0.0,
        deterministic=True, impl=impl)
    loss, _ = cola_loss(z1, z2)
    loss.backward()
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    return float(loss.detach()), mean.numpy(), var.numpy(), grads


def _check(cfg_kw, T, impls):
    variables, x1, x2, lj, bsj, gj = _jax_run(cfg_kw, T)
    want = {k: v.numpy() for k, v in from_jax({"params": gj}).items()}
    for impl in impls:
        lp, mean, var, gp = _port_run(cfg_kw, variables, x1, x2, impl)
        np.testing.assert_allclose(lp, lj, rtol=1e-5, err_msg=impl)
        assert set(gp) == set(want)
        for k, b in want.items():
            scale = max(np.abs(b).max(), 1e-6)
            np.testing.assert_allclose(gp[k], b, rtol=G_RTOL, atol=G_ATOL * scale,
                                       err_msg=f"{impl}: grad {k}")
        # the bn0 running statistics, chained through the two encoder calls
        np.testing.assert_allclose(mean, bsj["encoder"]["bn0"]["mean"], rtol=1e-5)
        np.testing.assert_allclose(var, bsj["encoder"]["bn0"]["var"], rtol=1e-5)


def test_cola_train_matches_jax_tiny():
    """The train block's Function (plain versions on the CPU) and plain
    autograd, each against the JAX fused train path."""
    _check(TINY, 40, ("kernel", "autograd"))


def test_cola_train_matches_jax_narrow_window8():
    _check(NARROW8, 40, ("kernel",))


def test_droppath_multipliers_and_dropout_are_drawn_from_the_generator():
    """Stochastic path: the same generator seed gives the same output, a
    different seed another (DropPath rate 0.9 at the deep blocks)."""
    cfg = HTSATConfig(**{**TINY, "drop_path_rate": 0.9})
    model = Cola(htsat=cfg)
    from heart_murmur_detection_tpu_torch.models.htsat import init_weights

    init_weights(model, torch.Generator().manual_seed(0))
    x = torch.randn(2, 40, 16, generator=torch.Generator().manual_seed(1))
    outs = []
    for seed in (0, 0, 1):
        with torch.no_grad():
            (z1, _), _ = cola_train_apply(model, x, x, torch.Generator().manual_seed(seed))
        outs.append(z1)
    assert torch.isfinite(outs[0]).all()
    assert torch.equal(outs[0], outs[1])
    assert not torch.allclose(outs[0], outs[2])
    assert dataclasses.asdict(cfg)["drop_path_rate"] == 0.9
