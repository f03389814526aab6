"""MAE / Audio-MAE continued-pretraining loop on one device — counterpart of
heart_murmur_detection_tpu/pretrain/mae_training.py (`mae_train_multiple_data`
:29).

method='mae'      : OPERA-GT's ViT-S encoder (img 256x64, patch 4) with the
                    swin-v2-cr decoder (256 wide, 16 heads, 16 blocks)
method='audiomae' : Audio-MAE's ViT-B/16 (img 1024x128) with a 512-wide
                    decoder; pretrain='audiomae' warm-starts the whole model
                    from pretrained.pth (strict, decoder included), as the
                    reference does (mae_training.py:311-313)

Protocol: mask ratio 0.7, batch 64, Adam 1e-4 with x0.99/epoch decay,
multi-corpus weighted sampling (full batches only), top-5 checkpoints by
valid_loss every 5 epochs and a resume checkpoint every 5.

A step: host sampler -> x (B, max_len, n_mels) on the device ->
models.mae_train_fused.mae_train_loss_fused (the encoder's blocks through
the ViT train kernels for bf16 on a card, the decoder in plain torch) ->
backward -> Adam. The eval loss is the same loss without gradients, the
encoder on the eval kernels. Masking noise comes from the run's generator
(seed + 1 + the first epoch), one draw a train step and an eval batch.

Data parallelism (mesh, a parallel/mesh.py DataParallelMesh: this function
runs in every rank): every rank draws the same global batch from the same
seeded sampler and the masking noise of the whole batch (B, L) from a
generator seeded the same on every rank (the JAX package hoists the noise
out of its shard_map, mae_training.py:140-142), then runs its contiguous
rows of both through the same step; its loss share is its masked mean over
n, and one all-reduce of the flat gradient completes the step (the JAX
pmean, exact: equal shard sizes, a static len_keep). param_sharding="fsdp"
is ZeRO-3 over the data axis on the plain path (fused_train=True with it
is refused). Rank 0 writes the checkpoints and the CSV.

On a dp x tp mesh the rows, the noise rows and the loss mean follow the
data axis (model peers run the same rows with the same noise);
"megatron" places the ViT encoder's and the SwinV2-CR decoder's blocks
over the model axis (parallel/tensor.py, models/tp_blocks.py), "fsdp" is
ZeRO-3 over it, and every 2-D run takes the plain path.

compute_dtype=torch.bfloat16 is the bf16 flow of the JAX fused step;
None is strict float32, differentiated by torch autograd. TF32 stays off
for every float32 product.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..models.vit_mae import (
    MaskedAutoencoderViT,
    audiomae_base_config,
    init_weights,
    mae_vit_small_config,
)
from ..models import mae_train_fused
from ..parallel import tensor
from ..parallel.mesh import (check_mesh, check_param_sharding, local_rows,
                             shard_params_and_opt, shard_rows)
from ..train.checkpoints import ResumeCheckpointer, TopKCheckpointer
from ..utils.logging import CSVLogger
from ..utils.precision import strict_f32
from . import steps
from .cola_training import train_impl
from .data import MultiCorpusSampler, load_corpus


def batch_rows(x: np.ndarray, patch: int, gen: torch.Generator, mesh, device):
    """A step's inputs from the global batch x (B, T, F): (this rank's rows
    on `device`, their rows of the global batch's masking noise (B, L),
    drawn from gen as the single-device step draws it; None without a
    mesh, where the step draws it)."""
    xl = torch.from_numpy(shard_rows(x, mesh)).to(device, non_blocking=True)
    if mesh is None:
        return xl, None
    noise = mae_train_fused.masking_noise(x.shape[0], (x.shape[1] // patch) * (x.shape[2] // patch),
                                          gen, device)
    return xl, shard_rows(noise, mesh)


def mae_train_multiple_data(
    title: str,
    data_source: Dict[str, int],
    n_epoches: int = 150,
    training_method: str = "mae",
    pretrain: Optional[str] = None,
    batch_size: int = 64,
    lr: float = 1e-4,
    seed: int = 42,
    ckpt_root: str = "cks/model/combined",
    log_dir: str = "cks/logs",
    mesh=None,
    param_sharding: Optional[str] = None,
    corpora: Optional[list] = None,
    manifest_fn=None,
    verbose: bool = True,
    config_override=None,
    resume: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    fused_train: Optional[bool] = None,
    device="cuda",
    ckpt_path: Optional[str] = None,
    initial_state: Optional[dict] = None,
):
    """MAE continued pretraining -> (state_dict, history, best checkpoint
    path). history has one dict an epoch: epoch, train_loss, valid_loss,
    and the epoch's steps, samples and train_seconds (device-synchronised
    wall time of its training steps).

    initial_state: a state_dict of the MAE (decoder included) to start from
    instead of the seeded random init. ckpt_path: the Audio-MAE checkpoint
    of pretrain='audiomae' (default: the reference's path, not in the
    repository). mesh: this rank's DataParallelMesh or TensorParallelMesh
    (the run takes the mesh's device); param_sharding: "fsdp" (ZeRO-3),
    "megatron" (2-D mesh: the ViT encoder's and the SwinV2-CR decoder's
    blocks over the model axis, models/tp_blocks.py) or None."""
    mesh = check_mesh(mesh)
    param_sharding = check_param_sharding(mesh, param_sharding)
    device = mesh.device if mesh is not None else torch.device(device)
    verbose = verbose and (mesh is None or mesh.rank == 0)  # rank 0 prints
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA card is available (pass device='cpu')")
    if mesh is not None:
        local_rows(batch_size, mesh)  # "not divisible" before anything runs
    if config_override is not None:
        cfg = config_override
    elif pretrain == "audiomae" or training_method == "audiomae":
        cfg = audiomae_base_config(mask_ratio=0.7)
    else:
        cfg = mae_vit_small_config(mask_ratio=0.7)
    mm_dtype = torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32
    impl = train_impl(compute_dtype, fused_train, device, param_sharding, mesh)

    model = MaskedAutoencoderViT(cfg, decoder=True)
    if initial_state is not None:
        model.load_state_dict(initial_state)
    else:
        init_weights(model, torch.Generator().manual_seed(seed))
    if pretrain == "audiomae":
        from ..extract import convert, registry

        path = ckpt_path or registry._AUDIOMAE_PATHS["audiomae"]
        if not os.path.exists(path):
            raise registry._missing(pretrain, path)
        convert.load_mae_ckpt(path, model)
    model.to(device).train()
    if param_sharding == "megatron":
        tensor.shard_model(model, mesh)

    if corpora is None:
        corpora = [
            load_corpus(name, max_len, training_method,
                        manifest=manifest_fn(name) if manifest_fn else None)
            for name, max_len in data_source.items()
        ]
    sampler = MultiCorpusSampler(corpora, batch_size, "mae", seed=seed)
    make_opt = lambda ps: steps.adam_with_epoch_decay(ps, sampler.steps_per_epoch, lr=lr,
                                                      decay=0.99)
    zero = None
    if param_sharding == "fsdp":
        zero, opt = shard_params_and_opt(list(model.parameters()), mesh, make_opt)
    else:
        opt = make_opt(list(model.parameters()))

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
                print(f"[mae-cp {title}] resumed at epoch {start_epoch}")
    if zero is not None:
        zero.release()  # the parameters rest as this rank's shard

    ckpt = TopKCheckpointer(
        dirpath=run_dir,
        filename_fmt="encoder-" + title + "-epoch={epoch:02d}--valid_acc={valid_acc:.2f}-valid_loss={valid_loss:.4f}.ckpt",
        monitor="valid_loss",
        mode="min",
        save_top_k=5,
        every_n_epochs=5,
        mesh=mesh,
    )
    logger = CSVLogger(os.path.join(log_dir, "combined"), title, mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(seed + 1 + start_epoch)
    steps.restore_rng(extra, sampler, gen, mesh)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    rows = lambda x: batch_rows(x, cfg.patch_size, gen, mesh, device)

    with strict_f32():
        history = []
        for epoch in range(start_epoch, n_epoches):
            t0 = time.time()
            losses, samples = [], 0
            for _ in range(sampler.steps_per_epoch):
                s, x = sampler.next_batch()
                xl, noise = rows(x)
                loss = steps.mae_train_step(model, opt, xl, mm_dtype, impl, noise, gen, mesh, zero)
                losses.append((s, loss))
                samples += x.shape[0]
            sync()
            train_seconds = time.time() - t0
            if zero is not None:
                zero.gather()  # the whole model for the eval and the checkpoints
            vl = []
            for _, x in sampler.val_batches():
                xl, noise = rows(x)
                vl.append(float(steps.mae_eval_step(model, xl, mm_dtype, impl, noise, gen, mesh)))
            valid_loss = float(np.mean(vl)) if vl else float("nan")
            train_loss = float(np.mean([float(l) for _, l in losses]))
            per_corpus = {s: [] for s in range(len(sampler.corpora))}
            for s, l in losses:
                per_corpus[s].append(float(l))
            logger.log(
                epoch=epoch,
                train_loss=train_loss,
                valid_loss=valid_loss,
                # per-drawn-corpus columns, same naming as the COLA CP logger
                **{f"train{s}_loss": (float(np.mean(v)) if v else float("nan"))
                   for s, v in sorted(per_corpus.items())},
            )
            history.append(dict(epoch=epoch, train_loss=train_loss, valid_loss=valid_loss,
                                steps=len(losses), samples=samples,
                                train_seconds=train_seconds))
            if verbose:
                print(f"[mae-cp {title}] epoch {epoch} train {train_loss:.4f} "
                      f"valid {valid_loss:.4f} ({time.time() - t0:.1f}s)")
            ckpt.step(epoch, valid_loss, tensor.state_dict(model), valid_acc=0.0)
            if resume_ckpt.due(epoch):
                resume_ckpt.save(epoch, tensor.state_dict(model), steps.full_opt_state(opt, zero),
                                 steps.rng_state(sampler, gen, mesh))
            if zero is not None:
                zero.release()
    if zero is not None:
        zero.gather()
    return tensor.state_dict(model), history, ckpt.best_path
