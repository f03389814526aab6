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
               device: torch.device) -> str:
    """The swin blocks' route (ops.swin_train.fused_swin_block_train impl):
    the train kernels for bf16 on a card unless fused_train=False; the plain
    versions of the kernels for bf16 otherwise; torch autograd in float32."""
    if compute_dtype != torch.bfloat16:
        return "autograd"
    if fused_train is None:
        fused_train = device.type == "cuda"
    return "kernel" if fused_train else "plain"


def forward_backward(model: Cola, x1, x2, gen, mm_dtype, impl: str, p_drop: float):
    """One pair forward and backward: gradients land in the parameters'
    .grad; returns (loss, accuracy, the new BatchNorm statistics as a
    models/bn.py dict: bn0 of the HTS-AT, the 49 of the EfficientNet)."""
    if model.kind == "efficientnet":
        dtype = None if mm_dtype == torch.float32 else mm_dtype
        (z1, z2), stats = model.train_pair(x1, x2, gen, p_drop, dtype)
    else:
        (z1, z2), bn0 = cola_train_apply(model, x1, x2, gen, p_drop, mm_dtype, impl=impl)
        stats = {model.htsat.bn0: bn0}
    loss, acc = cola_loss(z1, z2)
    loss.backward()
    return loss.detach(), acc.detach(), stats


def train_step(model: Cola, opt: steps.EpochDecayAdam, x1, x2, gen, mm_dtype,
               impl: str, p_drop: float):
    """One CP step: forward, backward, Adam, BatchNorm statistics. -> (loss, acc)."""
    opt.zero_grad()
    loss, acc, stats = forward_backward(model, x1, x2, gen, mm_dtype, impl, p_drop)
    opt.step()
    bn_mod.commit(stats)
    return loss, acc


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
    EfficientNet's drop-connect rate."""
    if encoder not in ("htsat", "efficientnet"):
        raise ValueError(f"encoder {encoder!r}: 'htsat' or 'efficientnet'")
    if mesh is not None or param_sharding is not None:
        raise NotImplementedError("multi-device CP (mesh, param_sharding) is not ported")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA card is available (pass device='cpu')")
    mm_dtype = torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32
    impl = train_impl(compute_dtype, fused_train, device)

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

    if corpora is None:
        corpora = [
            load_corpus(name, max_len, "cola", manifest=manifest_fn(name) if manifest_fn else None)
            for name, max_len in data_source.items()
        ]
    sampler = MultiCorpusSampler(corpora, batch_size, "cola", seed=seed)
    trainable = steps.make_frozen(
        model, _cola_early_freeze if freeze_encoder == "early" else None)
    opt = steps.adam_with_epoch_decay(trainable, sampler.steps_per_epoch, lr=lr, decay=0.99)

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
                print(f"[cola-cp {title}] resumed at epoch {start_epoch}")

    ckpt = TopKCheckpointer(
        dirpath=run_dir,
        filename_fmt="encoder-" + title + "-epoch={epoch:02d}--valid_acc={valid_acc:.2f}-valid_loss={valid_loss:.4f}.ckpt",
        monitor="valid_loss",
        mode="min",
        save_top_k=5,
        every_n_epochs=10,
    )
    logger = CSVLogger(os.path.join(log_dir, "combined"), title)
    gen = torch.Generator(device=device).manual_seed(seed + 1 + start_epoch)
    put = lambda a: torch.from_numpy(a).to(device, non_blocking=True)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    with strict_f32():
        history = []
        for epoch in range(start_epoch, n_epoches):
            t0 = time.time()
            tr_losses, pairs = [], 0
            for _ in range(sampler.steps_per_epoch):
                s, (x1, x2) = sampler.next_batch()
                loss, _ = train_step(model, opt, put(x1), put(x2), gen, mm_dtype, impl, dropout_p)
                tr_losses.append((s, loss))
                pairs += x1.shape[0]
            sync()
            train_seconds = time.time() - t0
            if (epoch + 1) % eval_every == 0:
                model.eval()
                vl, va = [], []
                for s, (x1, x2) in sampler.val_batches():
                    z1, z2 = model.forward_pair(put(x1), put(x2), mm_dtype,
                                                "kernel" if impl == "kernel" else "plain")
                    loss, acc = cola_loss(z1, z2)
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
                ckpt.step(epoch, valid_loss, model.state_dict(), valid_acc=valid_acc)
            resume_ckpt.save(epoch, model.state_dict(), opt.state_dict())
    return model.state_dict(), history, ckpt.best_path
