"""COLA continued-pretraining loop for the HTS-AT (OPERA-CT) or
EfficientNet-B0 (OPERA-CE) encoder on one device — counterpart of
heart_murmur_detection_tpu/pretrain/cola_training.py (`train_multiple_data`).

Protocol: batch 64 pairs, Adam 1e-4 with x0.99/epoch decay, multi-corpus
weighted sampling (one corpus per step), top-5 checkpoints by valid_loss
every 10 epochs, a resume checkpoint every 5, optional warm start from a base
OPERA checkpoint and optional freeze_encoder='early' (bn0 and the stage-0
blocks of the HTS-AT, as the JAX package freezes them; its patterns name
no EfficientNet module, so there it freezes nothing, as in the JAX package).

A step: host sampler -> (x1, x2) on the device -> the training forward of
both views (HTS-AT: cola_train_apply, through the swin train kernels for
bf16 on a card; EfficientNet: Cola.train_pair, torch autograd on cuDNN with
train-mode BatchNorms and drop-connect at dropout_p) -> cola_loss ->
backward -> Adam -> the BatchNorms' running statistics (bn0 of the HTS-AT,
the 49 of the EfficientNet). The eval loss runs the eval pair forward with
the running statistics.

Data parallelism (mesh, a parallel/mesh.py DataParallelMesh: this function
runs in every rank): every rank draws the same global batch from the same
seeded sampler (drop_last, as the JAX package forces under a mesh) and runs
its contiguous rows of it; both encoders' BatchNorms see the global batch
(sync-BN); the projections z1, z2 of every rank are gathered so that each
rank computes the same global cola_loss, whose backward keeps the rank's
own rows (gather_rows); one all-reduce of the flat gradient then completes
the step. The eval loss gathers the same way. Dropout and DropPath draw
from a generator of the rank's own (rank_generator). param_sharding="fsdp"
is ZeRO-3 over the data axis (parallel/mesh.py::ZeroShard: parameters and
Adam state as a 1/n shard a rank, the model gathered at the start of each
step, gradients reduce-scattered) on the plain path, as the JAX package
runs param_sharding on its XLA graphs; fused_train=True with
param_sharding is refused. The train kernels run under a plain mesh, each
rank on its rows. Rank 0 writes the checkpoints and the CSV.

On a dp x tp mesh (parallel/mesh.py::TensorParallelMesh) rows, gathers,
sync-BN and the generators follow the data axis (model peers run the same
rows and draw alike); param_sharding="megatron" (the CLI's default there)
places the HTS-AT's blocks over the model axis (parallel/tensor.py; the
EfficientNet's 4-D convs match no rule and stay replicated, as in the JAX
package) and runs them through models/tp_blocks.py; "fsdp" is ZeRO-3 over
the model axis; None keeps every parameter whole on every rank. Every
2-D run takes the plain path (fused_train=True raises, as in the JAX
trainers). Checkpoints and the returned state_dict hold the full
single-device tensors, gathered from the model ranks.

compute_dtype=torch.bfloat16 is the bf16 flow of the JAX path (HTS-AT:
stages 0-2 in bf16 through the train kernels, everything else float32;
EfficientNet: bf16 convolutions with float32 BatchNorms); None is strict
float32, differentiated by torch autograd. TF32 stays off for every float32
product, as the JAX path runs them at HIGHEST or in full float32.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..models import bn as bn_mod
from ..models.cola import Cola, cola_loss
from ..models.htsat import HTSATConfig, init_weights
from ..models.htsat_train_fused import cola_train_apply
from ..parallel import tensor
from ..parallel.mesh import (ZeroShard, check_mesh, check_param_sharding, gather_rows,
                             local_rows, plain_only, rank_generator, shard_params_and_opt,
                             shard_rows)
from ..train.checkpoints import ResumeCheckpointer, TopKCheckpointer
from ..utils.logging import CSVLogger
from ..utils.precision import strict_f32
from . import steps
from .data import MultiCorpusSampler, load_corpus

ENCODER = "encoder.encoder.htsat."


def _cola_early_freeze(name: str) -> bool:
    """freeze_encoder='early': bn0 and the stage-0 blocks do not train."""
    return not name.startswith((ENCODER + "bn0.", ENCODER + "layers.0.blocks."))


def train_impl(compute_dtype: Optional[torch.dtype], fused_train: Optional[bool],
               device: torch.device, param_sharding: Optional[str] = None, mesh=None) -> str:
    """The swin blocks' route (ops.swin_train.fused_swin_block_train impl),
    one rule with train/finetune.py::train_impl: "kernel" with fused_train
    (None: on a card in bf16) — the train kernels for CUDA tensors (the
    HTS-AT's K8 and the MAE towers' K9, each in bf16 or in its float32
    mode: at float32 the float32 kernels, never a silent switch to
    autograd), their plain versions with the explicit backward for CPU
    tensors (the JAX fused path's interpret mode); else "plain" in bf16 and
    torch "autograd" in float32.
    param_sharding (ZeRO-3, megatron) and a 2-D mesh keep the plain path,
    as the JAX package keeps its XLA graphs there; fused_train=True with
    them is a ValueError (parallel/mesh.py::plain_only)."""
    if plain_only(mesh, fused_train, param_sharding):
        fused_train = False
    bf16 = compute_dtype == torch.bfloat16
    if fused_train is None:
        fused_train = device.type == "cuda" and bf16
    if fused_train:
        return "kernel"
    return "plain" if bf16 else "autograd"


def forward_backward(model: Cola, x1, x2, gen, mm_dtype, impl: str, p_drop: float, mesh=None):
    """One pair forward and backward: gradients land in the parameters'
    .grad; returns (loss, accuracy, the new BatchNorm statistics as a
    models/bn.py dict: bn0 of the HTS-AT, the 49 of the EfficientNet).
    mesh: x1, x2 are this rank's rows; the loss is the global batch's and
    the gradients are this rank's share of it (parallel/mesh.py)."""
    if model.kind == "efficientnet":
        dtype = None if mm_dtype == torch.float32 else mm_dtype
        (z1, z2), stats = model.train_pair(x1, x2, gen, p_drop, dtype, mesh=mesh)
    else:
        (z1, z2), bn0 = cola_train_apply(model, x1, x2, gen, p_drop, mm_dtype, impl=impl,
                                         mesh=mesh)
        stats = {model.htsat.bn0: bn0}
    loss, acc = cola_loss(gather_rows(z1, mesh), gather_rows(z2, mesh))
    loss.backward()
    return loss.detach(), acc.detach(), stats


def train_step(model: Cola, opt: steps.EpochDecayAdam, x1, x2, gen, mm_dtype,
               impl: str, p_drop: float, mesh=None, zero: Optional[ZeroShard] = None):
    """One CP step: forward, backward, Adam, BatchNorm statistics. -> (loss, acc).
    mesh: this rank's rows of a data-parallel step, the gradient shares
    summed by one all-reduce; zero: ZeRO-3 (opt updates zero.shard; the
    model is gathered for the step and released after it)."""
    opt.zero_grad()
    if zero is not None:
        zero.gather()
    loss, acc, stats = forward_backward(model, x1, x2, gen, mm_dtype, impl, p_drop, mesh)
    steps.reduce_grads(opt, mesh, zero)
    opt.step()
    bn_mod.commit(stats)
    return loss, acc


def eval_loss(model: Cola, x1, x2, mm_dtype, impl: str, mesh=None):
    """The eval pair forward and cola_loss of a validation batch (the
    global batch's, gathered from the ranks' rows, with a mesh)."""
    z1, z2 = model.forward_pair(x1, x2, mm_dtype, "kernel" if impl == "kernel" else "plain")
    return cola_loss(gather_rows(z1, mesh), gather_rows(z2, mesh))


def train_multiple_data(
    title: str,
    data_source: Dict[str, int],
    dim_fea: int = 1280,
    dim_hidden: int = 1280,
    dim_out: int = 512,
    encoder: str = "efficientnet",
    n_epoches: int = 512,
    pretrain: Optional[str] = None,
    freeze_encoder: str = "none",
    batch_size: int = 64,
    lr: float = 1e-4,
    seed: int = 42,
    ckpt_root: str = "cks/model/combined",
    log_dir: str = "cks/logs",
    mesh=None,
    param_sharding: Optional[str] = None,
    corpora: Optional[list] = None,
    manifest_fn=None,
    eval_every: int = 1,
    verbose: bool = True,
    htsat_config: Optional[HTSATConfig] = None,
    resume: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    fused_train: Optional[bool] = None,
    dropout_p: float = 0.1,
    device="cuda",
    ckpt_path: Optional[str] = None,
    initial_state: Optional[dict] = None,
):
    """Continued pretraining of Cola(encoder) -> (state_dict, history, best
    checkpoint path). history has one dict an eval epoch: epoch, train_loss,
    valid_loss, valid_acc, and the epoch's steps, pairs and train_seconds
    (device-synchronised wall time of its training steps).

    encoder: "efficientnet" (the default, as in the JAX package) or "htsat".
    pretrain: warm-start the model from the port's registry (operaCT or
    operaCE kinds; ckpt_path names the checkpoint, which is not in the
    repository). initial_state: a state_dict of models.cola.Cola to start
    from instead of the seeded random init. For the HTS-AT, dim_fea and
    dim_hidden resolve to its latent (768), as in the JAX package; the
    EfficientNet's features are 1280 wide, with a `middle` Linear when
    dim_hidden differs. dropout_p is the projector's dropout and the
    EfficientNet's drop-connect rate. mesh: this rank's DataParallelMesh
    or TensorParallelMesh (the run takes the mesh's device); param_sharding:
    "fsdp" (ZeRO-3), "megatron" (2-D mesh) or None (see the module doc)."""
    if encoder not in ("htsat", "efficientnet"):
        raise ValueError(f"encoder {encoder!r}: 'htsat' or 'efficientnet'")
    mesh = check_mesh(mesh)
    param_sharding = check_param_sharding(mesh, param_sharding)
    device = mesh.device if mesh is not None else torch.device(device)
    verbose = verbose and (mesh is None or mesh.rank == 0)  # rank 0 prints
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA card is available (pass device='cpu')")
    if mesh is not None:
        local_rows(batch_size, mesh)  # "not divisible" before anything runs
    mm_dtype = torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32
    impl = train_impl(compute_dtype, fused_train, device, param_sharding, mesh)

    model = Cola(htsat_config or HTSATConfig(), dim_out=dim_out, encoder=encoder,
                 dim_hidden=dim_hidden, p=dropout_p)
    if initial_state is not None:
        model.load_state_dict(initial_state)
    else:
        init_weights(model, torch.Generator().manual_seed(seed))
    if pretrain and pretrain != "None":
        from ..extract import registry

        loaded = registry.initialize_pretrained_model(pretrain, ckpt_path).state_dict()
        # warm start: the overlapping entries (models_cola.py:230-234, strict=False)
        own = model.state_dict()
        model.load_state_dict({k: loaded.get(k, v) for k, v in own.items()})
    model.to(device).train()
    if param_sharding == "megatron":
        tensor.shard_model(model, mesh)

    if corpora is None:
        corpora = [
            load_corpus(name, max_len, "cola", manifest=manifest_fn(name) if manifest_fn else None)
            for name, max_len in data_source.items()
        ]
    # with a mesh, batches divide evenly over the ranks: drop_last, as the
    # JAX package forces (its cola_training.py:107-111)
    sampler = MultiCorpusSampler(corpora, batch_size, "cola", seed=seed,
                                 drop_last=True if mesh is not None else None)
    trainable = steps.make_frozen(
        model, _cola_early_freeze if freeze_encoder == "early" else None)
    make_opt = lambda ps: steps.adam_with_epoch_decay(ps, sampler.steps_per_epoch, lr=lr,
                                                      decay=0.99)
    zero = None
    if param_sharding == "fsdp":
        zero, opt = shard_params_and_opt(trainable, mesh, make_opt)
    else:
        opt = make_opt(trainable)

    run_dir = os.path.join(ckpt_root, "_".join(data_source.keys()))
    resume_ckpt = ResumeCheckpointer(os.path.join(run_dir, title), every_n_epochs=5, mesh=mesh)
    start_epoch, extra = 0, {}
    if resume:
        restored = resume_ckpt.restore()
        if restored is not None:
            epoch_r, sd, opt_state, extra = restored
            steps.load_train_state(model, opt, zero, sd, opt_state)
            start_epoch = epoch_r + 1
            if verbose:
                print(f"[cola-cp {title}] resumed at epoch {start_epoch}")
    if zero is not None:
        zero.release()  # the parameters rest as this rank's shard

    ckpt = TopKCheckpointer(
        dirpath=run_dir,
        filename_fmt="encoder-" + title + "-epoch={epoch:02d}--valid_acc={valid_acc:.2f}-valid_loss={valid_loss:.4f}.ckpt",
        monitor="valid_loss",
        mode="min",
        save_top_k=5,
        every_n_epochs=10,
        mesh=mesh,
    )
    logger = CSVLogger(os.path.join(log_dir, "combined"), title, mesh=mesh)
    gen = rank_generator(seed + 1 + start_epoch, mesh, device)
    steps.restore_rng(extra, sampler, gen, mesh)
    put = lambda a: torch.from_numpy(shard_rows(a, mesh)).to(device, non_blocking=True)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    with strict_f32():
        history = []
        for epoch in range(start_epoch, n_epoches):
            t0 = time.time()
            tr_losses, pairs = [], 0
            for _ in range(sampler.steps_per_epoch):
                s, (x1, x2) = sampler.next_batch()
                loss, _ = train_step(model, opt, put(x1), put(x2), gen, mm_dtype, impl, dropout_p,
                                     mesh, zero)
                tr_losses.append((s, loss))
                pairs += x1.shape[0]
            sync()
            train_seconds = time.time() - t0
            if zero is not None:
                zero.gather()  # the whole model for the eval and the checkpoints
            if (epoch + 1) % eval_every == 0:
                model.eval()
                if model.kind == "htsat":
                    model.htsat.invalidate_prepared()  # the eval layouts of this epoch's weights
                vl, va = [], []
                for s, (x1, x2) in sampler.val_batches():
                    loss, acc = eval_loss(model, put(x1), put(x2), mm_dtype, impl, mesh)
                    vl.append(float(loss))
                    va.append(float(acc))
                model.train()
                valid_loss = float(np.mean(vl)) if vl else float("nan")
                valid_acc = float(np.mean(va)) if va else float("nan")
                train_loss = float(np.mean([float(l) for _, l in tr_losses]))
                # per-corpus means, keyed train{s}_loss by corpus index like the
                # reference's weighted-draw logging (models_cola.py:327-329)
                per_corpus = {s: [] for s in range(len(sampler.corpora))}
                for s, l in tr_losses:
                    per_corpus[s].append(float(l))
                corpus_losses = {  # stable CSV header: every corpus, every epoch
                    f"train{s}_loss": (float(np.mean(v)) if v else float("nan"))
                    for s, v in sorted(per_corpus.items())
                }
                logger.log(
                    epoch=epoch,
                    train_loss=train_loss,
                    valid_loss=valid_loss,
                    valid_acc=valid_acc,
                    **corpus_losses,
                )
                history.append(dict(epoch=epoch, train_loss=train_loss, valid_loss=valid_loss,
                                    valid_acc=valid_acc, steps=len(tr_losses), pairs=pairs,
                                    train_seconds=train_seconds))
                if verbose:
                    print(
                        f"[cola-cp {title}] epoch {epoch} train {train_loss:.4f} "
                        f"valid {valid_loss:.4f} acc {valid_acc:.3f} ({time.time()-t0:.1f}s)"
                    )
                ckpt.step(epoch, valid_loss, tensor.state_dict(model), valid_acc=valid_acc)
            if resume_ckpt.due(epoch):
                resume_ckpt.save(epoch, tensor.state_dict(model), steps.full_opt_state(opt, zero),
                                 steps.rng_state(sampler, gen, mesh))
            if zero is not None:
                zero.release()
    if zero is not None:
        zero.gather()
    return tensor.state_dict(model), history, ckpt.best_path
