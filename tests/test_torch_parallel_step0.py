"""Step-0 gradients of every data-parallel path (parallel/mesh.py) against the
port's single-device step, on gloo ranks spawned on the CPU: COLA on the
HTS-AT (DP at world 2 and 4, ZeRO-3) and the EfficientNet (DP, its 49
BatchNorms on the global batch), MAE (DP, ZeRO-3; the masking noise drawn
for the global batch) and fine-tuning (DP, ZeRO-3, the weighted loss over
an uneven class mix with padded rows, SpecAugment drawn for the global
batch). Each case runs the trainer's own step function
(cola_training.train_step, mae_training.batch_rows + steps.mae_train_step,
finetune.train_step) with its optimizer at learning rate 0, in strict
float32 on the same weights and global batch; the summed gradients the
step left (all_reduce_grads, or the ZeRO-3 reduce-scatter gathered back)
are compared leaf by leaf and by the global norm. Two deliberately broken variants, patched in the ranks,
show what the bar catches: an all-gather whose backward sums the
cotangents (n times the gradient) and a BatchNorm whose synced moments have
no backward. Also the mesh's rules: mesh_from_cli against the JAX
function, shard_rows against shard_batch's layout, ZeRO-3's state size.
The world-2 cases (the broken variants and ZeRO-3's state size among them)
share one launch, the world-4 case a second; the single-device steps run
in this process meanwhile."""

import concurrent.futures

import numpy as np
import pytest
import torch

from heart_murmur_detection_tpu_torch.models.cola import Cola
from heart_murmur_detection_tpu_torch.models.htsat import HTSATConfig
from heart_murmur_detection_tpu_torch.models.htsat import init_weights as htsat_init
from heart_murmur_detection_tpu_torch.models.vit_mae import MaskedAutoencoderViT, MAEConfig
from heart_murmur_detection_tpu_torch.models.vit_mae import init_weights as mae_init
from heart_murmur_detection_tpu_torch.parallel import launch, mesh
from heart_murmur_detection_tpu_torch.train import finetune as ft
from tests import torch_parallel_ranks as R


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads in the test process (the ranks take one each):
    the test run shares the cores among its xdist workers (see
    test_torch_swin.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TINY = dict(spec_size=64, patch_size=4, embed_dim=16, depths=(1, 1, 1, 1),
            num_heads=(2, 2, 2, 2), window_size=2, mel_bins=16, drop_path_rate=0.0)
MAE = MAEConfig(img_size=(32, 16), patch_size=4, embed_dim=32, depth=2, num_heads=2,
                decoder_embed_dim=16, decoder_depth=2, decoder_num_heads=2, mask_ratio=0.7)
# Leaf by leaf: allclose(rtol=GRAD_RTOL, atol=GRAD_ATOL * max|g|), max|g| over
# the whole gradient. Splitting the batch moves float32 gradients by up to
# ~4e-6 of max|g| on the HTS-AT and 1.1-1.5e-5 on the EfficientNet's first
# convolution (upstream of its 49 BatchNorms; oneDNN's convolutions sum in
# another order at another batch), so the scale is 3e-5; an n-times
# gradient (every leaf 2x) or a sync-BN without its backward (4.7 max|g|)
# moves leaves by far more (the broken cases below).
GRAD_RTOL, GRAD_ATOL = 1e-5, 3e-5
NORM_TOL = 1e-4  # the global gradient norm's ratio to the single device's


def _cola_state(encoder, seed=0):
    m = Cola(HTSATConfig(**TINY), encoder=encoder, p=0.0,
             dim_hidden=None if encoder == "htsat" else 1280)
    htsat_init(m, torch.Generator().manual_seed(seed))
    return m.state_dict()


def _cases(world):
    r = np.random.default_rng(3)
    B = 8
    x1, x2 = (r.random((B, 32, 16)).astype(np.float32) for _ in range(2))
    e1, e2 = ((r.standard_normal((B, 32, 64)) * 4 - 20).astype(np.float32) for _ in range(2))
    cola = dict(state=_cola_state("htsat"), htsat=TINY, encoder="htsat", x1=x1, x2=x2)
    eff = dict(state=_cola_state("efficientnet"), htsat=TINY, encoder="efficientnet", x1=e1,
               x2=e2)
    model = MaskedAutoencoderViT(MAE, decoder=True)
    mae_init(model, torch.Generator().manual_seed(1))
    mae = dict(state=model.state_dict(), cfg=MAE, x=r.random((B, 32, 16)).astype(np.float32),
               seed=5)
    clf = ft.EncoderClassifier("htsat", 2, "linear", 128, HTSATConfig(**TINY),
                               torch.Generator().manual_seed(2))
    # rank 0 draws class 0 only, rank 1 both; the last two rows are padding
    y = np.array([0, 0, 0, 0, 1, 0, 1, 1], np.int64)
    valid = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    ftk = dict(state=clf.state_dict(), kind="htsat", htsat=TINY,
               x=(r.random((B, 32, 16)) + 0.8 * y[:, None, None]).astype(np.float32), y=y,
               valid=valid, cw=np.array([0.3, 1.7], np.float32), aug=(6, 3))
    if world == 4:
        return {"cola-dp": ("cola", cola)}
    return {"cola-dp": ("cola", cola), "cola-zero3": ("cola", {**cola, "zero": True}),
            "efficientnet-dp": ("cola", eff), "mae-dp": ("mae", mae),
            "mae-zero3": ("mae", {**mae, "zero": True}), "ft-dp": ("ft", ftk),
            "ft-zero3": ("ft", {**ftk, "zero": True})}


BROKEN = {  # a variant, its case, and the (module, name, value) it patches in the ranks
    "gather": ("cola-dp", ("heart_murmur_detection_tpu_torch.pretrain.cola_training",
                           "gather_rows", R.naive_gather)),
    "bn": ("efficientnet-dp", ("heart_murmur_detection_tpu_torch.parallel.mesh",
                               "all_reduce_mean_autograd", R.mean_without_backward)),
}


@pytest.fixture(scope="module")
def step0():
    """{(world, case): (single-device result, mesh result)}, the broken
    variants' mesh results under ("broken", variant) and ZeRO-3's state
    sizes under "zero-size"."""
    fns = {"cola": "cola_step0", "mae": "mae_step0", "ft": "ft_step0"}
    two, four = _cases(2), _cases(4)
    cases2 = {name: (fns[fn], kw) for name, (fn, kw) in two.items()}
    for b, (case, patch) in BROKEN.items():
        cases2[f"broken-{b}"] = ("call", dict(target="tests.torch_parallel_ranks:step0_cases",
                                              kwargs={"cases": {case: two[case]}},
                                              patches=(patch,)))
    cases2["zero-size"] = ("zero_state_size", dict(n_params=5))
    cases4 = {name: (fns[fn], kw) for name, (fn, kw) in four.items()}
    ranks = lambda: (launch(R.cases, 2, cases2, device="cpu"),
                     launch(R.cases, 4, cases4, device="cpu"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pending = pool.submit(ranks)
        single = {name: getattr(R, fns[fn])(None, **kw) for name, (fn, kw) in two.items()}
        got2, got4 = pending.result()
    out = {(2, name): (single[name], got2[name]) for name in two}
    out.update({(4, name): (single[name], got4[name]) for name in four})  # the same inputs
    out.update({("broken", b): got2[f"broken-{b}"][case] for b, (case, _) in BROKEN.items()})
    out["zero-size"] = got2["zero-size"]
    return out


def _grad_rule(want: dict, got: dict):
    """The leaves off the bar and the global norm ratio."""
    gmax = max(float(g.abs().max()) for g in want.values())
    off = [k for k, g in want.items()
           if not torch.allclose(got[k], g, rtol=GRAD_RTOL, atol=GRAD_ATOL * gmax)]
    norm = lambda gs: torch.sqrt(sum((g.double() ** 2).sum() for g in gs.values()))
    return off, float(norm(got) / norm(want))


CASES = [(2, c) for c in ("cola-dp", "cola-zero3", "efficientnet-dp", "mae-dp", "mae-zero3",
                          "ft-dp", "ft-zero3")] + [(4, "cola-dp")]


@pytest.mark.parametrize("world,case", CASES)
def test_step0_gradients_match_single_device(step0, world, case):
    want, got = step0[(world, case)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    off, ratio = _grad_rule(want[1], got[1])
    assert not off, (case, off[:5])
    assert abs(ratio - 1) <= NORM_TOL, ratio
    if case.startswith(("cola", "efficientnet")):  # the running statistics the step committed
        init = _cola_state("efficientnet" if "eff" in case else "htsat")
        moved = [k for k in want[2] if k.endswith("running_mean")
                 and not torch.equal(want[2][k], init[k])]
        assert len(moved) == (49 if "eff" in case else 1) and set(got[2]) == set(want[2])
        for k, b in want[2].items():
            torch.testing.assert_close(got[2][k], b, rtol=1e-5, atol=1e-6)
    if case.startswith("mae"):  # every rank's masks are its rows of the global draw's
        assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("broken", ["gather", "bn"])
def test_the_gradient_rule_catches_broken_reductions(step0, broken):
    """The rank function runs with gather_rows replaced by an all-gather that
    sums cotangents (world 2: twice the gradient), or with the
    EfficientNet's synced BatchNorm moments cut from autograd (dx misses the
    other rank's path through them): the bar rejects both by orders of
    magnitude over the split's float32 noise. (bn0 of the HTS-AT normalises
    the input, so its moments carry no gradient to any parameter.)"""
    case = BROKEN[broken][0]
    want = step0[(2, case)][0]
    got = step0[("broken", broken)]
    off, ratio = _grad_rule(want[1], got[1])
    gmax = max(float(g.abs().max()) for g in want[1].values())
    worst = max(float((got[1][k] - want[1][k]).abs().max()) for k in want[1]) / gmax
    if broken == "gather":
        assert abs(ratio - 2) < 1e-3 and len(off) == len(want[1])
    else:
        assert len(off) > len(want[1]) // 2 and worst > 100 * GRAD_ATOL, (len(off), worst)


def test_shard_rows_is_shard_batch_layout():
    """Rank r holds rows [r b / n, (r + 1) b / n), as the JAX shard_batch
    places them (tests/test_parallel.py:584), and an odd batch raises."""
    import jax

    from heart_murmur_detection_tpu.parallel.mesh import data_parallel_mesh, shard_batch

    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    (xs,) = shard_batch((x,), data_parallel_mesh(8))
    for i, sh in enumerate(xs.addressable_shards):
        m = mesh.DataParallelMesh(i, 8, None, "gloo", torch.device("cpu"))
        np.testing.assert_array_equal(np.asarray(sh.data), mesh.shard_rows(x, m))
    assert jax.device_count() == 8
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard_rows(x[:7], mesh.DataParallelMesh(0, 2, None, "gloo", torch.device("cpu")))


@pytest.mark.parametrize("cfg", [
    {}, {"dp": 2}, {"dp": 4, "param_sharding": "fsdp"}, {"dp": 1, "param_sharding": "fsdp"},
    {"tp": 2}, {"dp": 2, "tp": 2}, {"dp": 2, "tp": 2, "param_sharding": "fsdp"},
    {"dp": 2, "dist_backend": "gloo"},
])
def test_mesh_from_cli_matches_jax(cfg):
    """The JAX contract: dp=N -> an N-rank plan with param_sharding as given;
    tp=M -> a dp x tp plan, megatron unless param_sharding says fsdp (JAX
    tests/test_cli_config.py:40); nothing -> (None, None); param_sharding
    without a mesh -> ValueError."""
    from heart_murmur_detection_tpu.parallel import mesh as jmesh

    try:
        want = jmesh.mesh_from_cli(cfg)
    except ValueError as e:
        with pytest.raises(ValueError, match="requires a device mesh"):
            mesh.mesh_from_cli(cfg)
        assert "requires a device mesh" in str(e)
        return
    plan, ps = mesh.mesh_from_cli(cfg)
    assert ps == want[1]
    if want[0] is None:
        assert plan is None
        return
    assert plan.backend == cfg.get("dist_backend") and plan.world == want[0].devices.size
    assert (plan.n, plan.tp) == tuple(want[0].devices.shape) + (1,) * (2 - want[0].devices.ndim)
    if cfg.get("tp", 1) > 1:
        assert want[0].axis_names == ("data", "model")


def test_trainer_mesh_rules():
    """A mesh that is not the port's raises TypeError; megatron has no
    tensor axis to shard over on the 1-D mesh (its error names the 'model'
    axis, as the JAX param_sharding_axis's); NCCL is never given more ranks
    than cards; a multi-rank mesh needs a process group."""
    with pytest.raises(TypeError, match="DataParallelMesh"):
        mesh.check_mesh(object())
    m = mesh.DataParallelMesh(0, 2, None, "gloo", torch.device("cpu"))
    with pytest.raises(ValueError, match="model"):
        mesh.check_param_sharding(m, "megatron")
    assert mesh.check_param_sharding(None, "fsdp") is None  # as the JAX trainers ignore it
    with pytest.raises(ValueError, match="dist_backend=gloo"):
        mesh.check_backend("nccl", torch.cuda.device_count() + 1, "cuda")
    with pytest.raises(RuntimeError, match="launch"):
        mesh.data_parallel_mesh(2, device="cpu")


def test_zero3_holds_a_shard_of_the_adam_state(step0):
    """ZeRO-3 over 2 ranks: each holds ceil(total / 2) elements of the
    parameters and of each Adam moment; the parameters hold no storage at
    rest."""
    got = step0["zero-size"]
    assert got["total"] == 5000 and got["shard"] == got["exp_avg"] == got["exp_avg_sq"] == 2500
    assert got["params"] == [0] * 5


@pytest.mark.parametrize("local", [8, 9])
def test_nccl_counts_the_cards_of_this_node(monkeypatch, local):
    """A torchrun group over two nodes (world 16, rank 9) takes NCCL where
    this node has a card for each of its LOCAL_WORLD_SIZE ranks (8 cards),
    and is refused with the gloo hint where it has fewer; the global world
    is not held against one node's cards."""

    class Reached(Exception):
        pass

    def init_group(backend, rank, world, init_method, device):
        assert (backend, rank, world, init_method, device) == ("nccl", 9, 16, "env://",
                                                               torch.device("cuda", 1))
        raise Reached

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(mesh, "init_group", init_group)
    for k, v in dict(RANK="9", WORLD_SIZE="16", LOCAL_RANK="1", LOCAL_WORLD_SIZE=str(local),
                     MASTER_ADDR="node0").items():
        monkeypatch.setenv(k, v)
    if local == 8:
        with pytest.raises(Reached):
            mesh.data_parallel_mesh(16, backend="nccl", device="cuda")
    else:
        with pytest.raises(ValueError, match="9 ranks on this node.*dist_backend=gloo"):
            mesh.data_parallel_mesh(16, backend="nccl", device="cuda")
