"""Rank functions of the data- and tensor-parallel tests
(tests/test_torch_parallel_*.py).

parallel.launch runs each in spawned processes, which import this module by
name: it imports torch and the port only (no JAX), so a rank starts fast.
Every function takes the rank's mesh first (None: the single-device run in
the calling process) and returns host tensors or numbers. A test file
hands every case it needs to one launch (`cases`), since starting ranks is
the costly part.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import time

import numpy as np
import torch

from heart_murmur_detection_tpu_torch.models.clap import CLAPConfig as _CLAPConfig
from heart_murmur_detection_tpu_torch.models.hear import HeARConfig as _HeARConfig
from heart_murmur_detection_tpu_torch.models.htsat import HTSATConfig as _HTSATConfig
from heart_murmur_detection_tpu_torch.parallel import tensor
from heart_murmur_detection_tpu_torch.parallel.mesh import (ZeroShard, data_axis, gather_objects,
                                                            rank_generator, shard_rows)

# the CLAP-2023 HTS-AT narrowed (over CLAP's 64 mel bins) and HeAR's narrow
# tower (tests/test_torch_hear.py's width), where the classifiers build them
CLAP_HTSAT = dict(spec_size=128, patch_size=4, embed_dim=16, depths=(1, 1, 1, 1),
                  num_heads=(2, 2, 2, 2), window_size=2, drop_path_rate=0.0)
HEAR_WAVE = dict(image_size=(192, 128), patch_size=16, hidden=64, depth=1, heads=2,
                 mlp_ratio=4.0, pooled_dim=8)


def clap_htsat(**kw):
    """models.clap.HTSATConfig narrowed to CLAP_HTSAT."""
    return _HTSATConfig(**{**CLAP_HTSAT, **kw})


def clap_config(**kw):
    """models.clap.CLAPConfig with the projection's dropout off."""
    return _CLAPConfig(**{**kw, "proj_dropout": 0.0})


def hear_config():
    """models.hear.HeARConfig narrowed to HEAR_WAVE."""
    return _HeARConfig(**HEAR_WAVE)


# the port's side of tests/test_torch_finetune.py::narrow_zoo, as (module,
# name, value) patches a rank can take (`patched`, `call`)
NARROW_ZOO = (("heart_murmur_detection_tpu_torch.models.clap", "CLAPConfig", clap_config),
              ("heart_murmur_detection_tpu_torch.models.clap", "HTSATConfig", clap_htsat),
              ("heart_murmur_detection_tpu_torch.models.hear", "HeARConfig", hear_config))


@contextlib.contextmanager
def patched(patches=()):
    """(module, name, value) attributes replaced for the block's duration."""
    saved = []
    for mod, name, value in patches:
        m = importlib.import_module(mod)
        saved.append((m, name, getattr(m, name)))
        setattr(m, name, value)
    try:
        yield
    finally:
        for m, name, value in reversed(saved):
            setattr(m, name, value)


def call(mesh, target: str, kwargs: dict, patches=()):
    """module:function(mesh=mesh, **kwargs) with (module, name, value)
    attributes patched for the call; its result."""
    mod, fn = target.split(":")
    with patched(patches):
        return getattr(importlib.import_module(mod), fn)(mesh=mesh, **kwargs)


def cases(mesh, cases: dict):
    """Every case of a test file in one launch: {name: (function, kwargs)},
    each function a name in this module called as fn(mesh, **kwargs).
    A case whose kwargs hold "expect" (an exception type's name) returns
    the message of the exception it raised, which every rank raises before
    any collective. out["seconds"]: each case's wall time in this rank."""
    out = {"seconds": {}}
    for name, (fn, kw) in cases.items():
        kw = dict(kw)
        expect = kw.pop("expect", None)
        t0 = time.perf_counter()
        if expect is None:
            out[name] = globals()[fn](mesh, **kw)
            out["seconds"][name] = time.perf_counter() - t0
            continue
        try:
            globals()[fn](mesh, **kw)
        except Exception as e:  # noqa: BLE001 — the test checks its type and message
            if type(e).__name__ != expect:
                raise
            out[name] = str(e)
        else:
            raise AssertionError(f"{name}: no {expect}")
        out["seconds"][name] = time.perf_counter() - t0
    return out


def digests(state: dict) -> dict:
    """{name: SHA-1 of the tensor's bytes}."""
    return {k: hashlib.sha1(v.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
            for k, v in state.items()}


def run_peers(mesh, target: str, kwargs: dict, patches=()):
    """call(...) of a trainer returning (state_dict, ...) or a result with a
    .state_dict: (the result, every rank's digests of that state_dict, in
    rank order), so a test sees that the replicated parameters agree bit
    for bit across the ranks."""
    out = call(mesh, target, kwargs, patches)
    sd = out.state_dict if hasattr(out, "state_dict") else out[0]
    return out, gather_objects(digests(sd), mesh)


class Feed:
    """A masking_noise stand-in handing out given (B, L) arrays in order;
    a draw of another shape fails."""

    def __init__(self, noises):
        self.noises = list(noises)

    def __call__(self, B, L, gen, dev):
        noise = self.noises.pop(0)
        assert noise.shape == (B, L), (noise.shape, B, L)
        return torch.tensor(noise, device=dev)


def _summed_grads(named, grads, zero):
    """The step's summed gradients by name: `grads` (one a parameter of
    `named`, as the step left or returned them; a tensor-parallel shard's
    gathered from the model axis), or under ZeRO-3 the full gradient
    gathered from the shards' (zero.shard.grad)."""
    if zero is None:
        out = {}
        for (k, p), g in zip(named, grads):
            pl = tensor.placement(p)
            out[k] = (pl.gather(g) if pl is not None and pl.kind == "shard" else g).cpu().clone()
        return out
    full, out, o = zero.gather_flat(zero.shard.grad), {}, 0
    for (k, _), n, s in zip(named, zero.numels, zero.shapes):
        out[k] = full[o:o + n].view(s).cpu().clone()
        o += n
    return out


def _optimizer(params, mesh, zero: bool, make_opt, model=None, megatron: bool = False):
    """(ZeroShard or None, optimizer) as the trainers set them up: ZeRO-3
    (the parameters rest as this rank's shard) or the optimizer over params
    (of `model`, first placed on the tensor axis with megatron)."""
    from heart_murmur_detection_tpu_torch.parallel.mesh import shard_params_and_opt

    if megatron and mesh is not None:
        tensor.shard_model(model, mesh)
    if zero and mesh is not None:
        zs, opt = shard_params_and_opt(params, mesh, make_opt)
        zs.release()
        return zs, opt
    return None, make_opt(params)


def _lr0_adam(ps):
    """The CP optimizer at learning rate 0: the step leaves the weights."""
    from heart_murmur_detection_tpu_torch.pretrain import steps

    return steps.adam_with_epoch_decay(ps, 1, lr=0.0)


def cola_step0(mesh, state: dict, htsat: dict, encoder: str, x1, x2, zero: bool = False,
               mm_dtype=torch.float32, impl: str = "autograd", megatron: bool = False):
    """One COLA step of the trainer (cola_training.train_step, Adam at lr 0)
    on the global batch (x1, x2) from `state`, dropout and DropPath off:
    its loss, the summed gradients it left, and the BatchNorms' running
    statistics it committed (by buffer name); with megatron also every
    parameter's shape on this rank."""
    from heart_murmur_detection_tpu_torch.models.cola import Cola
    from heart_murmur_detection_tpu_torch.models.htsat import HTSATConfig
    from heart_murmur_detection_tpu_torch.pretrain import cola_training as ct
    from heart_murmur_detection_tpu_torch.utils.precision import strict_f32

    model = Cola(HTSATConfig(**htsat), encoder=encoder, p=0.0,
                 dim_hidden=None if encoder == "htsat" else 1280)
    model.load_state_dict(state)
    model.train()
    named = list(model.named_parameters())
    zs, opt = _optimizer([p for _, p in named], mesh, zero, _lr0_adam, model, megatron)
    x1, x2 = (torch.from_numpy(shard_rows(x, mesh)) for x in (x1, x2))
    with strict_f32():
        loss, _ = ct.train_step(model, opt, x1, x2, rank_generator(0, mesh, "cpu"), mm_dtype,
                                impl, 0.0, mesh, zs)
    grads = _summed_grads(named, [p.grad for _, p in named] if zs is None else None, zs)
    bn = {k: b.cpu().clone() for k, b in model.named_buffers()
          if k.endswith(("running_mean", "running_var"))}
    if megatron:
        return float(loss), grads, bn, {k: tuple(p.shape) for k, p in named}
    return float(loss), grads, bn


def mae_step0(mesh, state: dict, cfg, x, seed: int, zero: bool = False, mm_dtype=torch.float32,
              impl: str = "autograd", megatron: bool = False):
    """One MAE step of the trainer (mae_training.batch_rows, then
    steps.mae_train_step, Adam at lr 0) on the global batch x, its masking
    noise drawn from a generator seeded `seed`: the loss, the summed
    gradients, and the masks of the global batch (every rank's rows)."""
    from heart_murmur_detection_tpu_torch.models import mae_train_fused
    from heart_murmur_detection_tpu_torch.models.vit_mae import MaskedAutoencoderViT
    from heart_murmur_detection_tpu_torch.pretrain import mae_training, steps
    from heart_murmur_detection_tpu_torch.utils.precision import strict_f32

    model = MaskedAutoencoderViT(cfg, decoder=True)
    model.load_state_dict(state)
    named = list(model.named_parameters())
    zs, opt = _optimizer([p for _, p in named], mesh, zero, _lr0_adam, model, megatron)
    gen = torch.Generator().manual_seed(seed)
    xl, noise = mae_training.batch_rows(x, cfg.patch_size, gen, mesh, "cpu")
    with strict_f32():
        loss = steps.mae_train_step(model, opt, xl, mm_dtype, impl, noise, gen, mesh, zs)
    grads = _summed_grads(named, [p.grad for _, p in named] if zs is None else None, zs)
    # the masks the step formed: from the rows' noise, or (one device) from
    # the generator's draw inside the masked encoder, as the step draws it
    if zs is not None:
        zs.gather()
    with torch.no_grad():
        _, mask, _ = mae_train_fused.mae_encode_train_fused(
            model, xl, noise, None if mesh is not None else torch.Generator().manual_seed(seed))
    mask = torch.cat(gather_objects(mask.cpu(), data_axis(mesh)))
    return float(loss), grads, mask


def ft_step0(mesh, state: dict, kind: str, htsat: dict, x, y, valid, cw, zero: bool = False,
             aug=None, head: str = "linear", megatron: bool = False, mae=None, feat_dim=None,
             dtype=torch.float32):
    """One fine-tuning step of the trainer (finetune.train_step, ClippedAdam
    at lr 0) on the global batch (x, y, valid rows), SpecAugment `aug`
    drawn from a generator seeded 7: its global loss and the summed
    gradients it returned; with megatron also every parameter's shape on
    this rank. mae: the gt / audiomae MAEConfig's fields; feat_dim: the
    head's input width (default the HTS-AT's features); dtype: the model's
    and the batch's (float64 for a tower whose every op takes it)."""
    from heart_murmur_detection_tpu_torch.models.htsat import HTSATConfig
    from heart_murmur_detection_tpu_torch.models.vit_mae import MAEConfig
    from heart_murmur_detection_tpu_torch.train import finetune as ft
    from heart_murmur_detection_tpu_torch.train.linear_eval import ClippedAdam
    from heart_murmur_detection_tpu_torch.utils.precision import strict_f32

    cfg = HTSATConfig(**htsat)
    model = ft.EncoderClassifier(kind, 2, head, feat_dim or cfg.num_features, cfg,
                                 MAEConfig(**mae) if mae else None)
    model.load_state_dict(state)
    model.to(dtype).train()
    keep = set(map(id, ft.trainable_params(model, "none")))
    named = [(k, p) for k, p in model.named_parameters() if id(p) in keep]
    zs, opt = _optimizer([p for _, p in named], mesh, zero,
                         lambda ps: ClippedAdam(ps, 1, 0.0, 0.99, 1.0, optax_clip=True,
                                                shard_mesh=mesh if zero else None),
                         model, megatron)
    x, valid, cw = (torch.as_tensor(a).to(dtype) for a in (x, valid, cw))
    y = torch.as_tensor(y)
    gen = torch.Generator().manual_seed(7)
    rank_gen = None if mesh is None else rank_generator(7, mesh, "cpu")
    with strict_f32():
        loss, grads = ft.train_step(model, opt, x, y, valid, cw, gen, torch.float32, "autograd",
                                    1e-4, aug, mesh, zs, rank_gen)
    if megatron:
        return float(loss), _summed_grads(named, grads, zs), {k: tuple(p.shape) for k, p in named}
    return float(loss), _summed_grads(named, grads, zs)


def sub_mesh_ft_step0(mesh, n_model: int, patches=(), **kw):
    """ft_step0 on a 1 x n_model tensor axis over the first n_model ranks of
    the launch's group (the rest wait): a model axis the launch's own mesh
    does not have (tp=3 in a 4-rank launch). Rank 0's result."""
    import torch.distributed as dist

    from heart_murmur_detection_tpu_torch.parallel.mesh import DataParallelMesh, TensorParallelMesh

    model_group = dist.new_group(list(range(n_model)))  # every rank makes every group
    alone = [dist.new_group([r]) for r in range(mesh.world)]
    out = None
    if mesh.rank < n_model:
        view = lambda r, w, g: DataParallelMesh(r, w, g, mesh.backend, mesh.device)
        sub = TensorParallelMesh(mesh.rank, n_model, model_group, mesh.backend, mesh.device,
                                 view(0, 1, alone[mesh.rank]), view(mesh.rank, n_model,
                                                                    model_group))
        with patched(patches):
            out = ft_step0(sub, **kw)
    dist.barrier(group=mesh.group)
    return out


def step0_cases(mesh, cases: dict):
    """Every case's step-0 result in one launch: {name: (fn, kwargs)}."""
    fns = {"cola": cola_step0, "mae": mae_step0, "ft": ft_step0}
    return {name: fns[fn](mesh, **kw) for name, (fn, kw) in cases.items()}


def peer_draws(mesh, seed: int, rows: int):
    """Every rank's draws, in rank order, from rank_generator(seed): a
    DropPath keep multiplier row and a dropout mask, as the trainers draw
    them."""
    from heart_murmur_detection_tpu_torch.models.htsat_train_fused import _dropout, _keep_mult

    gen = rank_generator(seed, mesh, "cpu")
    draw = (_keep_mult(gen, rows, 0.3, "cpu"), _dropout(gen, torch.ones(rows, 8), 0.5))
    return gather_objects(draw, mesh)


def zero_state_size(mesh, n_params: int):
    """The per-rank element count of a ZeroShard over n_params parameters
    of 1000 elements each, with its Adam state after one step."""
    from heart_murmur_detection_tpu_torch.pretrain import steps

    ps = [torch.nn.Parameter(torch.full((1000,), float(i))) for i in range(n_params)]
    zero = ZeroShard(ps, mesh)
    opt = steps.adam_with_epoch_decay([zero.shard], 1)
    zero.gather()
    sum(p.sum() for p in ps).backward()
    zero.reduce_grads()
    zero.release()
    opt.step()
    st = opt.opt.state[zero.shard]
    return {"shard": zero.shard.numel(), "exp_avg": st["exp_avg"].numel(),
            "exp_avg_sq": st["exp_avg_sq"].numel(), "params": [p.numel() for p in ps],
            "total": zero.total}


def naive_gather(x, mesh):
    """A broken gather_rows: an all-gather whose backward sums the
    cotangents over the ranks (n times the gradient)."""
    import torch.distributed.nn.functional as dfn

    return torch.cat(dfn.all_gather(x), 0)


def mean_without_backward(x, mesh):
    """A broken all_reduce_mean_autograd: the average, cut from autograd."""
    from heart_murmur_detection_tpu_torch.parallel.mesh import all_reduce_sum

    return all_reduce_sum(x, mesh) / mesh.world


def resume_runs(mesh, target: str, args8: dict):
    """(history, state) of an uninterrupted 8-epoch run (its resume
    checkpoint holds epoch 4) and of the same run resumed from that
    checkpoint in the same directory (epochs 5-7)."""
    mod, fn = target.split(":")
    train = getattr(importlib.import_module(mod), fn)
    b = train(mesh=mesh, **args8)
    r = train(mesh=mesh, **{**args8, "resume": True})
    return [(b[1], b[0]), (r[1], r[0])]



def extract_rank(mesh, state: dict, paths: list, fdir: str, kw: dict):
    """operaCT features of `paths` from an extractor with `state`, and what
    extract_and_save writes (random-init weights) into fdir, on this rank."""
    from heart_murmur_detection_tpu_torch.data.processors.common import extract_and_save
    from heart_murmur_detection_tpu_torch.extract.extract import FeatureExtractor

    ex = FeatureExtractor("operaCT", mesh=mesh, **kw)
    ex.model.load_state_dict(state)
    feats = ex.extract_files(paths)
    out = extract_and_save(fdir, "operaCT", dim=768, batch_size=kw["batch_size"],
                           random_init=True, device=kw["device"], mesh=mesh)
    return feats, np.load(out)


def extract_rows(mesh, state: dict, paths: list, kw: dict):
    """operaCT features of `paths` from an extractor with `state` on this
    rank (every rank's rows gathered), and the route its encoder took."""
    from heart_murmur_detection_tpu_torch.extract.extract import FeatureExtractor

    ex = FeatureExtractor("operaCT", mesh=mesh, **kw)
    ex.model.load_state_dict(state)
    return ex.extract_files(paths), ex._impl


def narrow_htsat():
    """A narrow HTS-AT with 768 features, in place of the full width
    (train.finetune.HTSATConfig, as tests/test_torch_finetune.py narrows it)."""
    from heart_murmur_detection_tpu_torch.models.htsat import HTSATConfig

    return HTSATConfig(spec_size=64, patch_size=4, embed_dim=96, depths=(1, 1, 1, 1),
                       num_heads=(2, 2, 2, 2), window_size=2, mel_bins=64, drop_path_rate=0.0)


NARROW = (("heart_murmur_detection_tpu_torch.pretrain.cola_training", "HTSATConfig", narrow_htsat),
          ("heart_murmur_detection_tpu_torch.train.finetune", "HTSATConfig", narrow_htsat))


def cli_tp_runs(mesh, root: str):
    """cli.pretrain (COLA on the HTS-AT) and cli.finetune (operaCT, then
    HeAR from its fbank_hear.npy cache; one seed each) with dp=2 tp=2
    dist_backend=gloo device=cpu, run from `root` in every rank of a 4-rank
    group as torchrun would run them, the HTS-AT and HeAR narrowed (NARROW,
    NARROW_ZOO): their results."""
    import os

    from heart_murmur_detection_tpu_torch.cli import finetune as cli_finetune
    from heart_murmur_detection_tpu_torch.cli import pretrain as cli_pretrain

    here = os.getcwd()
    os.chdir(root)
    try:
        with patched(NARROW + NARROW_ZOO):
            mesh_args = ["dp=2", "tp=2", "dist_backend=gloo", "device=cpu"]
            pre = cli_pretrain.main(["encoder=htsat", "method=cola", "circor=True",
                                     "batch_size=4", "epoches=1", "title=t"] + mesh_args)
            fin = cli_finetune.main(["task=circor_murmurs", "pretrain=operaCT",
                                     "random_init=True", "n_run=1", "epochs=1"] + mesh_args)
            hear = cli_finetune.main(["task=circor_murmurs", "pretrain=hear",
                                      "random_init=True", "n_run=1", "epochs=1"] + mesh_args)
    finally:
        os.chdir(here)
    return pre, fin, hear
