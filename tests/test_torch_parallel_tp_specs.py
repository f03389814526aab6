"""The tensor axis's rules, without ranks: parallel/tensor.py's placement
table against the JAX transformer_param_specs (tests/test_parallel.py:303,
:363) on trees carried over by extract/convert.py (a tiny HTS-AT Cola, a
tiny MAE with its SwinV2-CR decoder, a fine-tuning classifier with an mlp
head, and the CLAP 2022 / 2023 and HeAR classifiers) for mesh_2d(2, 4)
and (2, 2), megatron and fsdp; the replicated parameters used as a slice;
the head split of a qkv whose heads the model axis does not divide;
megatron on a 1-D mesh; fused_train refused on a 2-D mesh; the by-heads
layout of a column-parallel qkv."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heart_murmur_detection_tpu.models.vit_mae as jvit
import heart_murmur_detection_tpu.train.finetune as jft
from heart_murmur_detection_tpu.models.cola import Cola as JaxCola
from heart_murmur_detection_tpu.models.cola import ColaConfig
from heart_murmur_detection_tpu.models.htsat import HTSATConfig as JHTSATConfig
from heart_murmur_detection_tpu.parallel import mesh as jmesh
from heart_murmur_detection_tpu_torch.extract.convert import (from_jax, from_jax_classifier,
                                                              from_jax_mae)
from heart_murmur_detection_tpu_torch.models.cola import Cola
from heart_murmur_detection_tpu_torch.models.htsat import HTSATConfig
from heart_murmur_detection_tpu_torch.models.vit_mae import MaskedAutoencoderViT, MAEConfig
from heart_murmur_detection_tpu_torch.parallel import mesh, tensor
from heart_murmur_detection_tpu_torch.pretrain import cola_training, mae_training
from heart_murmur_detection_tpu_torch.train import finetune as ft

P = jax.sharding.PartitionSpec
TINY = dict(spec_size=64, patch_size=4, embed_dim=16, depths=(1, 1, 1, 1),
            num_heads=(2, 2, 4, 4), window_size=2, mel_bins=16, drop_path_rate=0.0)
MAE = dict(img_size=(32, 16), patch_size=4, embed_dim=32, depth=1, num_heads=4,
           decoder_embed_dim=16, decoder_depth=2, decoder_num_heads=4)


def fake_mesh(n_data: int, n_model: int, rank: int = 0) -> mesh.TensorParallelMesh:
    """A rank's TensorParallelMesh without process groups (for the rules
    that raise before any collective)."""
    cpu = torch.device("cpu")
    d, m = divmod(rank, n_model)
    view = lambda r, w: mesh.DataParallelMesh(r, w, None, "gloo", cpu)
    return mesh.TensorParallelMesh(rank, n_data * n_model, None, "gloo", cpu, view(d, n_data),
                                   view(m, n_model))


@pytest.fixture(scope="module")
def trees():
    """{name: (JAX params tree, converter to the port's names, the port's
    model)} at random init."""
    key = jax.random.PRNGKey(0)
    cola = JaxCola(ColaConfig(encoder="htsat", p=0.0),
                   htsat=JHTSATConfig(enable_tscam=False, **TINY))
    d = jnp.zeros((1, 64, 16))
    cv = jax.jit(lambda: cola.init(key, (d, d)))()
    mae = jvit.MaskedAutoencoderViT(jvit.MAEConfig(**MAE))
    mv = jax.jit(lambda: mae.init({"params": key, "masking": key}, jnp.zeros((1, 32, 16))))()
    clf = jft.EncoderClassifier(encoder_kind="htsat", classes=2, head="mlp", feat_dim=128,
                                htsat_config=JHTSATConfig(enable_tscam=False, **TINY))
    fv = jax.jit(lambda: clf.init({"params": key, "dropout": key}, jnp.zeros((1, 32, 16))))()
    return {
        "cola": (cv["params"], lambda t: from_jax({"params": t}),
                 Cola(HTSATConfig(**TINY), encoder="htsat", p=0.0)),
        "mae": (mv["params"], lambda t: from_jax_mae({"params": t}, decoder=True),
                MaskedAutoencoderViT(MAEConfig(**MAE), decoder=True)),
        "clf": (fv["params"], lambda t: from_jax_classifier({"params": t}, "htsat"),
                ft.EncoderClassifier("htsat", 2, "mlp", 128, HTSATConfig(**TINY))),
    }


def _jax_dims(params, specs, convert) -> dict:
    """The JAX specs as torch dims by port name: each leaf becomes the
    index along its sharded axis (-1 everywhere when replicated), carried
    over by the converter; the torch dim is the one along which it varies."""
    def code(x, s):
        x = np.asarray(x)
        axes = [i for i, a in enumerate(tuple(s) + (None,) * x.ndim) if a is not None][:1]
        if not axes:
            return np.full(x.shape, -1.0, np.float32)
        shape = [1] * x.ndim
        shape[axes[0]] = x.shape[axes[0]]
        return np.broadcast_to(np.arange(x.shape[axes[0]], dtype=np.float32).reshape(shape),
                               x.shape).copy()

    coded = jax.tree.map(code, params, specs, is_leaf=lambda v: isinstance(v, P))
    out = {}
    for k, v in convert(coded).items():
        v = v.numpy()
        varying = [d for d in range(v.ndim) if v.shape[d] > 1 and
                   not (np.diff(v, axis=d) == 0).all()]
        assert len(varying) <= 1, (k, varying)
        out[k] = varying[0] if varying else None
    return out


@pytest.mark.parametrize("rule", ["megatron", "fsdp"])
@pytest.mark.parametrize("shape", [(2, 4), (2, 2)])
@pytest.mark.parametrize("tree", ["cola", "mae", "clf"])
def test_placement_table_matches_transformer_param_specs(trees, tree, shape, rule):
    """Every parameter's shard dim equals the JAX spec's (fsdp at
    fsdp_min_size 64 so that the tiny trees have both sides)."""
    params, convert, model = trees[tree]
    kw = {"fsdp_min_size": 64} if rule == "fsdp" else {}
    want = _jax_dims(params, jmesh.transformer_param_specs(
        params, jmesh.mesh_2d(*shape), rule=rule, **kw), convert)
    got = tensor.param_specs(model.named_parameters(), shape[1], rule, **kw)
    names = [k for k, _ in model.named_parameters()]
    assert set(names) <= set(want)
    assert {k: got[k].shard for k in names} == {k: want[k] for k in names}
    sharded = [k for k in names if want[k] is not None]
    assert sharded  # each tree has both sides of the rule
    if rule == "megatron":
        kinds = {k: ("row" if want[k] == 1 else "col") for k in sharded}
        assert any(k.endswith("attn.qkv.weight") and v == "col" for k, v in kinds.items())
        assert any(k.endswith("attn.proj.weight") and v == "row" for k, v in kinds.items())
        assert all(want[k] is None for k in names if "patch_embed" in k)  # the conv proj
        if tree == "mae":
            assert kinds["decoder_blocks.0.attn.meta_mlp.fc1.weight"] == "col"
            assert kinds["decoder_blocks.0.attn.meta_mlp.fc2.weight"] == "row"
        if tree == "clf":
            assert kinds["head.fc1.weight"] == "col" and kinds["head.fc2.weight"] == "row"


@pytest.fixture(scope="module")
def zoo_trees():
    """{kind: (JAX params tree, converter, the port's classifier)} of the
    CLAP 2022 (its Cnn14 at full width), CLAP 2023 and HeAR classifiers,
    both packages' towers narrowed as tests/test_torch_finetune.py narrows
    them."""
    from tests.test_torch_finetune import NEW_KINDS, _new_jax, apply_narrow_zoo

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        apply_narrow_zoo(mp)
        for kind in ("clap", "clap2023", "hear"):
            _, v = _new_jax(kind)
            out[kind] = (v["params"], lambda t, k=kind: from_jax_classifier({"params": t}, k),
                         ft.EncoderClassifier(kind, 2, "linear", NEW_KINDS[kind][1]))
    return out


# per kind: (a leaf the megatron rule shards column-wise, leaves it keeps whole)
ZOO_LEAVES = {
    "clap": ("encoder.base.fc1.weight", ("encoder.base.fc_audioset.weight",
                                          "encoder.projection.linear1.weight")),
    "clap2023": ("encoder.base.htsat.layers.0.blocks.0.attn.qkv.weight",
                 ("encoder.base.htsat.tscam_conv.weight", "encoder.projection.linear2.weight")),
    "hear": ("encoder.blocks.0.mlp.fc1.weight", ("encoder.pooler.weight",
                                                 "encoder.patch_embed.proj.weight")),
}


@pytest.mark.parametrize("rule", ["megatron", "fsdp"])
@pytest.mark.parametrize("shape", [(2, 4), (2, 2)])
@pytest.mark.parametrize("kind", list(ZOO_LEAVES))
def test_zoo_placement_table_matches_transformer_param_specs(zoo_trees, kind, shape, rule):
    """The CLAP 2022 / 2023 and HeAR classifiers: every parameter's shard
    dim equals the JAX spec's; under megatron the Cnn14's fc1, the swin
    and ViT blocks' qkv / fc1 are column-parallel, and the tscam head,
    fc_audioset, the CLAP projection, HeAR's pooler and patch embed stay
    replicated."""
    params, convert, model = zoo_trees[kind]
    kw = {"fsdp_min_size": 64} if rule == "fsdp" else {}
    want = _jax_dims(params, jmesh.transformer_param_specs(
        params, jmesh.mesh_2d(*shape), rule=rule, **kw), convert)
    got = tensor.param_specs(model.named_parameters(), shape[1], rule, **kw)
    names = [k for k, _ in model.named_parameters()]
    assert set(names) <= set(want)
    assert {k: got[k].shard for k in names} == {k: want[k] for k in names}
    if rule == "megatron":
        col, whole = ZOO_LEAVES[kind]
        assert want[col] == 0 and all(want[k] is None for k in whole)


def test_odd_and_one_axis_cases():
    """A dimension the model axis does not divide stays replicated (the
    JAX `odd` fc1 at 65 columns, :333); fsdp's tiny / odd leaves (:363);
    megatron on a 1-D mesh raises naming 'model' (:458-459); fsdp picks the
    data axis there and the model axis on a 2-D mesh."""
    z = np.zeros
    jparams = {"odd": {"fc1": {"kernel": z((16, 65))}}, "big": z((48, 64)), "tiny": z((8,)),
               "oddf": z((130, 7))}
    js = jmesh.transformer_param_specs(jparams, jmesh.mesh_2d(2, 4), rule="megatron")
    assert js["odd"]["fc1"]["kernel"] == P()
    assert tensor.megatron_dim("odd.fc1.weight", (65, 16), 4) is None
    assert tensor.megatron_dim("odd.fc1.weight", (64, 16), 4) == 0
    jf = jmesh.transformer_param_specs(jparams, jmesh.mesh_2d(2, 4), rule="fsdp", fsdp_min_size=64)
    assert jf["big"] == P(None, "model") and jf["tiny"] == P() and jf["oddf"] == P()
    got = tensor.param_specs([("big", (48, 64)), ("tiny", (8,)), ("oddf", (130, 7))], 4, "fsdp",
                             fsdp_min_size=64)
    assert (got["big"].shard, got["tiny"].shard, got["oddf"].shard) == (1, None, None)
    one = mesh.DataParallelMesh(0, 2, None, "gloo", torch.device("cpu"))
    with pytest.raises(ValueError, match="model"):
        mesh.param_sharding_axis(one, "megatron")
    with pytest.raises(ValueError, match="model"):
        mesh.check_param_sharding(one, "megatron")
    assert mesh.param_sharding_axis(one, "fsdp") == "data"
    assert mesh.param_sharding_axis(fake_mesh(2, 2), "fsdp") == "model"
    assert mesh.check_param_sharding(fake_mesh(2, 2), "megatron") == "megatron"
    with pytest.raises(ValueError, match="no 'model' axis"):
        jmesh.transformer_param_specs(jparams, jmesh.data_parallel_mesh(8))


def test_slices_are_the_replicated_parameters_read_in_parts(trees):
    """The parameters JAX keeps replicated (P(), :332) that a model rank
    reads a part of: the column-parallel layers' biases (qkv, fc1,
    meta_mlp.fc1, the head's fc1), the swin relative-position tables'
    head columns and the SwinV2-CR taus; nothing else."""
    want = {
        "cola": ("attn.qkv.bias", "mlp.fc1.bias", "relative_position_bias_table"),
        "mae": ("attn.qkv.bias", "mlp.fc1.bias", "meta_mlp.fc1.bias", "attn.tau"),
        "clf": ("attn.qkv.bias", "mlp.fc1.bias", "relative_position_bias_table", "head.fc1.bias"),
    }
    for tree, (_, _, model) in trees.items():
        got = tensor.param_specs(model.named_parameters(), 2)
        sliced = {k for k, s in got.items() if s.slice is not None}
        assert sliced == {k for k, _ in model.named_parameters() if k.endswith(want[tree])}, tree
        for k in sliced:
            assert got[k].slice == (1 if k.endswith("table") else 0)


def _placed_parts(model, n: int) -> list:
    """shard_model of a copy of `model` on each model rank of a 1 x n
    fake_mesh (no collective runs): [(rank's named parameters, rank)]."""
    import copy

    return [(dict(tensor.shard_model(copy.deepcopy(model), fake_mesh(1, n, r))
                  .named_parameters()), r) for r in range(n)]


@pytest.mark.parametrize("tower", ["vit-s tp=4", "htsat tp=8"])
def test_heads_the_model_axis_cannot_split_take_the_head_split(tower):
    """ViT-S's 6 heads at tp=4 and the HTS-AT stage 0's 4 heads at tp=8
    (the rule shards their qkv: 3C divides): no ValueError; each rank holds
    the contiguous block of 3C / n qkv rows (GSPMD's split of the kernel)
    and of the bias, the stage's relative-position table whole (read by
    every rank); blocks whose heads divide keep the split by heads; the
    parts put back by Placement.index are the single-device tensors (the
    checkpoint's gather)."""
    if tower.startswith("vit"):
        model = MaskedAutoencoderViT(MAEConfig(img_size=(32, 16), patch_size=4, embed_dim=96,
                                               depth=1, num_heads=6))
        n, split, by_heads = 4, "blocks.0.attn", None
    else:
        model = Cola(HTSATConfig(**{**TINY, "embed_dim": 32, "num_heads": (4, 8, 16, 32)}),
                     encoder="htsat", p=0.0)
        n = 8
        split = "encoder.encoder.htsat.layers.0.blocks.0.attn"
        by_heads = "encoder.encoder.htsat.layers.1.blocks.0.attn"  # 8 heads
    full = dict(model.named_parameters())
    parts = _placed_parts(model, n)
    w = full[f"{split}.qkv.weight"]
    for named, r in parts:
        pw, pb = named[f"{split}.qkv.weight"], named[f"{split}.qkv.bias"]
        pl = tensor.placement(pw)
        assert pl.kind == "shard" and not pl.thirds and pw.shape == (w.shape[0] // n, w.shape[1])
        per = w.shape[0] // n
        assert torch.equal(pw, w[r * per:(r + 1) * per])
        assert tensor.placement(pb).kind == "slice" and not tensor.placement(pb).thirds
        assert torch.equal(tensor.local(pb), full[f"{split}.qkv.bias"][r * per:(r + 1) * per])
        if by_heads is not None:
            assert tensor.placement(named[f"{split}.relative_position_bias_table"]) is None
            assert tensor.placement(named[f"{by_heads}.qkv.weight"]).thirds
            assert tensor.placement(named[f"{by_heads}.relative_position_bias_table"]).kind \
                == "slice"
    for k, v in full.items():
        pl = tensor.placement(parts[0][0][k])
        if pl is None or pl.kind == "slice":
            assert all(torch.equal(named[k], v) for named, _ in parts), k
            continue
        back = torch.empty_like(v)
        for named, r in parts:
            back.index_copy_(pl.dim, pl.index(r, "cpu"), named[k].detach())
        assert torch.equal(back, v), k


def test_column_qkv_is_split_by_heads():
    """Model rank r of n holds the q, k and v rows of heads [r h / n, (r +
    1) h / n): the same row count as GSPMD's contiguous split, and the
    gathered rows (in rank order, put back by index) are the full tensor."""
    C, heads, n = 16, 4, 2
    w = torch.arange(3 * C * 2, dtype=torch.float32).reshape(3 * C, 2)
    parts = []
    for r in range(n):
        pl = tensor.Placement("shard", 0, 3 * C, True, fake_mesh(1, n, r))
        part = pl.take(w)
        hd = C // heads
        rows = [t * C + h * hd + i for t in range(3) for h in range(r * heads // n,
                                                                     (r + 1) * heads // n)
                for i in range(hd)]
        assert torch.equal(part, w[rows]) and part.shape == (3 * C // n, 2)
        parts.append((pl.index(r, "cpu"), part))
    full = torch.empty_like(w)
    for idx, part in parts:
        full.index_copy_(0, idx, part)
    assert torch.equal(full, w)


def test_fused_train_on_a_2d_mesh_is_refused(tmp_path):
    """fused_train=True with a dp x tp mesh raises "pure data parallelism"
    in each trainer before any collective (the JAX trainers' refusal,
    tests/test_parallel.py:221-231), under megatron and without a rule;
    fused_train=None picks the plain path there."""
    m = fake_mesh(2, 2)
    for ps in ("megatron", None):
        with pytest.raises(ValueError, match="pure data parallelism"):
            cola_training.train_multiple_data(
                "t", {"a": 32}, encoder="htsat", htsat_config=HTSATConfig(**TINY), mesh=m,
                param_sharding=ps, fused_train=True, compute_dtype=torch.bfloat16,
                batch_size=4, ckpt_root=str(tmp_path), log_dir=str(tmp_path))
        with pytest.raises(ValueError, match="pure data parallelism"):
            mae_training.mae_train_multiple_data(
                "t", {"a": 32}, mesh=m, param_sharding=ps, fused_train=True,
                compute_dtype=torch.bfloat16, batch_size=4, config_override=MAEConfig(**MAE),
                ckpt_root=str(tmp_path), log_dir=str(tmp_path))
        with pytest.raises(ValueError, match="pure data parallelism"):
            ft.train_impl(torch.bfloat16, True, torch.device("cuda"), ps, m)
    assert cola_training.train_impl(torch.bfloat16, None, torch.device("cuda"), None, m) == "plain"
    assert ft.train_impl(torch.bfloat16, None, torch.device("cuda"), None, m) == "plain"
    assert mesh.dp_axis(m) is None
