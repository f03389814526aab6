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
from ..train.checkpoints import ResumeCheckpointer, TopKCheckpointer
from ..utils.logging import CSVLogger
from ..utils.precision import strict_f32
from . import steps
from .cola_training import train_impl
from .data import MultiCorpusSampler, load_corpus


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
    repository)."""
    if mesh is not None or param_sharding is not None:
        raise NotImplementedError("multi-device CP (mesh, param_sharding) is not ported")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA card is available (pass device='cpu')")
    if config_override is not None:
        cfg = config_override
    elif pretrain == "audiomae" or training_method == "audiomae":
        cfg = audiomae_base_config(mask_ratio=0.7)
    else:
        cfg = mae_vit_small_config(mask_ratio=0.7)
    mm_dtype = torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32
    impl = train_impl(compute_dtype, fused_train, device)

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

    if corpora is None:
        corpora = [
            load_corpus(name, max_len, training_method,
                        manifest=manifest_fn(name) if manifest_fn else None)
            for name, max_len in data_source.items()
        ]
    sampler = MultiCorpusSampler(corpora, batch_size, "mae", seed=seed)
    opt = steps.adam_with_epoch_decay(list(model.parameters()), sampler.steps_per_epoch, lr=lr,
                                      decay=0.99)

    run_dir = os.path.join(ckpt_root, "_".join(data_source.keys()))
    resume_ckpt = ResumeCheckpointer(os.path.join(run_dir, title), every_n_epochs=5)
    start_epoch = 0
    if resume:
        restored = resume_ckpt.restore()
        if restored is not None:
            epoch_r, sd, opt_state, _ = restored
            model.load_state_dict(sd)
            opt.load_state_dict(opt_state)
            start_epoch = epoch_r + 1
            if verbose:
                print(f"[mae-cp {title}] resumed at epoch {start_epoch}")

    ckpt = TopKCheckpointer(
        dirpath=run_dir,
        filename_fmt="encoder-" + title + "-epoch={epoch:02d}--valid_acc={valid_acc:.2f}-valid_loss={valid_loss:.4f}.ckpt",
        monitor="valid_loss",
        mode="min",
        save_top_k=5,
        every_n_epochs=5,
    )
    logger = CSVLogger(os.path.join(log_dir, "combined"), title)
    gen = torch.Generator(device=device).manual_seed(seed + 1 + start_epoch)
    put = lambda a: torch.from_numpy(a).to(device, non_blocking=True)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    with strict_f32():
        history = []
        for epoch in range(start_epoch, n_epoches):
            t0 = time.time()
            losses, samples = [], 0
            for _ in range(sampler.steps_per_epoch):
                s, x = sampler.next_batch()
                loss = steps.mae_train_step(model, opt, put(x), mm_dtype, impl, generator=gen)
                losses.append((s, loss))
                samples += x.shape[0]
            sync()
            train_seconds = time.time() - t0
            vl = []
            for _, x in sampler.val_batches():
                vl.append(float(steps.mae_eval_step(model, put(x), mm_dtype, impl, generator=gen)))
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
            ckpt.step(epoch, valid_loss, model.state_dict(), valid_acc=0.0)
            resume_ckpt.save(epoch, model.state_dict(), opt.state_dict())
    return model.state_dict(), history, ckpt.best_path
