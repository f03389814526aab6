"""Fine-tuning harness — counterpart of heart_murmur_detection_tpu/train/
finetune.py (`EncoderClassifier` :58, `finetune_classifier` :130,
`build_ft_spectrogram_cache` :497, `finetune_heart` :550; the reference's
src/benchmark/other_eval/finetuning.py).

The protocol, step for step as the JAX package runs it:
- inputs: cached first-window inputs per clip (build_ft_spectrogram_
  cache): the (256, 64) mel of the first 8.18-s window for operaCT, operaCE
  and operaGT, the (998, 128) kaldi fbank of the first 10-s window for
  Audio-MAE, the 44.1-kHz waveform of a 5-s (2022) or 7-s (2023) crop for
  CLAP, the first 2-s window at 16 kHz for HeAR;
- model: encoder + models/heads.Head; loss = weighted softmax cross entropy
  of logits + 1e-10 over the batch's valid rows, + l2 * ||head||^2
  + 0.2 * l2 * ||encoder||^2 (every encoder parameter, frozen ones too);
- gradients of the trainable parameters clipped by their global norm (1.0),
  then Adam at lr * 0.99^(step // batches an epoch); frozen parameters
  (freeze_encoder none | all | early, models/heads.freeze_mask_fn) get no
  update;
- an epoch is train.linear_eval._make_perms' batches (padded rows weigh 0),
  optional SpecAugment on each batch (audio/augment.spec_augment);
- after each epoch the macro valid AUROC (predicted in padded batches of
  64); the best epoch by strict >, its weights kept; EarlyStopping (patience
  10, min_delta 1e-3) ends the run; test metrics from the best weights.

The encoder's train forward and backward (EncoderClassifier.encode_train):
- htsat: models/htsat_train_fused.htsat_encode_train, stages 0-2 on the
  swin train kernels (TPU K8), bn0 in train mode with its running
  statistics updated each step, DropPath from the run's generator;
- gt, audiomae: models/mae_train_fused.gt_backbone_train_fused /
  audiomae_backbone_train_fused, the 12 ViT blocks on the ViT train kernels
  (TPU K9: vit_qkv + vit_attn + vit_mlp forward, vit_attn_bwd + vit_mlp_bwd +
  swin_wgrad backward).
- efficientnet: models/efficientnet.py's train mode, torch autograd on
  cuDNN: every BatchNorm on the batch statistics with its running statistics
  updated each step (flax semantics, models/bn.py), drop-connect (0.1) from
  the run's generator, bf16 convolutions and float32 BatchNorms under
  compute_dtype=bfloat16;
- clap, clap2023: CLAPAudioEncoder.encode_train in float32 whatever
  compute_dtype says (the JAX CLAPAudioEncoder has none): the 44.1-kHz
  frontend, the Cnn14's BatchNorms or the HTS-AT's bn0 in train mode (the
  HTS-AT through htsat_encode_train's autograd route, DropPath on), the
  projection's dropout;
- hear: the HeAR ViT-L/16 in float32 (models/hear.py::HeAREncoder), the
  CLS token.
train_impl picks the route of htsat, gt and audiomae: the kernels
(fused_train; None = on a card in bf16), the kernels' plain versions with
their explicit backward in bf16 otherwise, torch autograd in float32 (TF32
off). Predictions run the eval forwards (the eval kernels on a card in bf16;
K1-K3 for htsat, K5-K7 for the ViTs; the EfficientNet in the compute dtype,
CLAP and HeAR in float32, as the JAX package predicts them through
model.apply).

Data parallelism (mesh, a parallel/mesh.py DataParallelMesh: the function
runs in every rank): the inputs stay whole on every rank, each step's
global batch is gathered (and SpecAugmented, from a generator seeded the
same on every rank) whole, then each rank runs its contiguous rows. The
rank's loss share is its (ce * w).sum() over the global batch's w.sum(),
plus the two L2 terms over n, so the shares sum to the single-device loss
whatever the class mix or the padded rows of each rank; one all-reduce of
the flat gradient completes the step. BatchNorms see the global batch
(sync-BN), DropPath and dropout draw from a generator of the rank's own.
Each rank keeps the kernel route: the kernels are local to the batch.
param_sharding="fsdp" is ZeRO-3 over the data axis (parameters and Adam
state as a 1/n shard a rank, the clip's global norm summed over ranks).
Every rank predicts the whole validation set; rank 0's AUROC decides.

On a dp x tp mesh (parallel/mesh.py::TensorParallelMesh) the rows, the
sync-BN, the weighted loss's w.sum() and the generators follow the data
axis. param_sharding="megatron" places every kind over the model axis by
the JAX rule (parallel/tensor.py, models/tp_blocks.py): the swin blocks of
htsat and clap2023, the ViT blocks of gt, audiomae and hear, the Cnn14's
fc1 (clap; its output all-gathered before fc_audioset and the projection),
an mlp head's fc1 / fc2; the EfficientNet's convs, the tscam heads, the
CLAP projections and HeAR's pooler match no rule and stay replicated. A
block whose heads the model axis does not divide takes the head split
(parallel/tensor.py). The L2 terms and the clip's global norm count each
shard once (the model axis's parts summed). "fsdp" is ZeRO-3 over the
model axis for every kind. Every 2-D run takes the plain path.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..audio import augment
from ..models import bn as bn_mod
from ..models import clap, hear
from ..models import htsat as htsat_mod
from ..models import vit_mae
from ..models.efficientnet import ColaEfficientNetEncoder
from ..models.heads import Head, freeze_mask_fn
from ..models.htsat import HTSAT, HTSATConfig
from ..models.htsat_train_fused import htsat_encode_train
from ..models.mae_train_fused import audiomae_backbone_train_fused, gt_backbone_train_fused
from ..models.vit_fused import audiomae_backbone_fused, mae_forward_feature_fused
from ..parallel import tensor
from ..parallel.mesh import (ZeroShard, all_reduce_grads, all_reduce_sum, broadcast_value,
                             check_mesh, check_param_sharding, data_size, is_2d, local_rows,
                             plain_only, rank_generator, shard_params_and_opt)
from ..utils.precision import strict_f32
from . import metrics as M
from .linear_eval import HEART_METRICS, ClippedAdam, _make_perms, get_class_weights

def _trainable_tscam(enc: HTSAT) -> None:
    """The HTS-AT's tscam head, where its config has one (enable_tscam and
    c_freq_bin > 0), as parameters under the buffers' names: the JAX
    classifier's tree holds it, so its L2 term, the clip and Adam read it.
    init_weights draws it last, as it draws the buffers."""
    if enc.tscam_conv is not None:
        classes, dim, kh, _ = enc.tscam_conv.weight.shape
        enc.tscam_conv = htsat_mod.TscamConv(dim, classes, kh, trainable=True)


class EncoderClassifier(nn.Module):
    """encoder + head (AudioClassifier, models_eval.py:320-411): parameters
    "encoder.*" under the reference's torch names (models/htsat.HTSAT,
    models/vit_mae.MaskedAutoencoderViT without its decoder but with its
    unread mask_token for gt, AudioMAEClassifierBackbone for audiomae,
    models/efficientnet.ColaEfficientNetEncoder for efficientnet,
    models/clap.CLAPAudioEncoder for clap / clap2023 — the 2023 HTS-AT with
    its unread tscam_conv, models/hear.HeAREncoder for hear) and "head.*".
    The unread leaves (gt's mask_token, the HTS-AT's tscam_conv of htsat and
    clap2023 (_trainable_tscam), the Cnn14's fc_audioset, HeAR's pooler) are
    in the JAX classifier's tree: they
    enter the loss through the encoder L2 term, so the clip's global norm
    and Adam see them (finetune.py:376-386). The head's input width follows
    the encoder where the encoder fixes it (efficientnet, clap, hear), as
    flax infers it. Seeded random weights from `generator`; load a JAX init
    with extract/convert.py::from_jax_classifier."""

    def __init__(self, encoder_kind: str, classes: int, head: str = "linear",
                 feat_dim: int = 768, htsat_config: Optional[HTSATConfig] = None,
                 mae_config: Optional[vit_mae.MAEConfig] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if encoder_kind == "htsat":
            self.encoder = HTSAT(htsat_config or HTSATConfig())
            _trainable_tscam(self.encoder)
            htsat_mod.init_weights(self.encoder, generator)
        elif encoder_kind == "gt":
            cfg = mae_config or vit_mae.mae_vit_small_config()
            self.encoder = vit_mae.MaskedAutoencoderViT(cfg)
            self.encoder.mask_token = nn.Parameter(torch.zeros(1, 1, cfg.decoder_embed_dim))
            vit_mae.init_weights(self.encoder, generator)
        elif encoder_kind == "audiomae":
            self.encoder = vit_mae.AudioMAEClassifierBackbone(
                mae_config or vit_mae.audiomae_base_config())
            vit_mae.init_weights(self.encoder, generator)
        elif encoder_kind == "efficientnet":
            self.encoder = ColaEfficientNetEncoder()
            htsat_mod.init_weights(self.encoder, generator)
            feat_dim = self.encoder.efficientnet._bn1.num_features
        elif encoder_kind in ("clap", "clap2023"):
            cfg = clap.CLAPConfig(version="2023" if encoder_kind == "clap2023" else "2022")
            self.encoder = clap.CLAPAudioEncoder(cfg)
            if encoder_kind == "clap2023":
                _trainable_tscam(self.encoder.base.htsat)
            clap.init_weights(self.encoder, generator)
            feat_dim = cfg.d_proj
        elif encoder_kind == "hear":
            self.encoder = hear.HeAREncoder(hear.HeARConfig())
            hear.init_weights(self.encoder, generator)
            feat_dim = self.encoder.config.hidden
        else:
            raise ValueError(f"unknown encoder_kind {encoder_kind!r}")
        self.encoder_kind = encoder_kind
        self.head = Head(classes, head, feat_dim, generator)

    def invalidate_prepared(self) -> None:
        """Drop the encoder's cached kernel layouts (after an update)."""
        for m in self.encoder.modules():
            if hasattr(m, "invalidate_prepared"):
                m.invalidate_prepared()

    def _lengths(self, x: torch.Tensor) -> torch.Tensor:
        return torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)

    def encode_train(self, x: torch.Tensor, gen: Optional[torch.Generator],
                     mm_dtype: torch.dtype, impl: str, mesh=None):
        """Train-mode encoder forward, differentiable: (features (B, D)
        float32, the new BatchNorm running statistics as a models/bn.py dict,
        or None for an encoder without BatchNorms). mesh: x is this rank's
        rows of a data-parallel batch; BatchNorms see the global batch."""
        kind, enc = self.encoder_kind, self.encoder
        if kind == "htsat":
            bn = enc.bn0
            h, new = htsat_encode_train(enc, x, gen, (bn.running_mean, bn.running_var),
                                        mm_dtype=mm_dtype, impl=impl, mesh=mesh)
            return h, {bn: new}
        if kind == "gt":
            return gt_backbone_train_fused(enc, x, mm_dtype, impl), None
        if kind == "audiomae":
            return audiomae_backbone_train_fused(enc, x, mm_dtype, impl), None
        if kind == "efficientnet":
            stats = bn_mod.new_stats(mesh)
            dtype = None if mm_dtype == torch.float32 else mm_dtype
            return enc(x, None, dtype, stats, gen), stats
        if kind in ("clap", "clap2023"):
            return enc.encode_train(x, self._lengths(x), gen, mesh)
        return enc(x)["cls"], None  # hear

    @torch.no_grad()
    def forward(self, x: torch.Tensor, mm_dtype: torch.dtype = torch.float32,
                impl: str = "kernel") -> torch.Tensor:
        """Eval logits (B, classes): the eval forwards of extraction. Their
        kernel layouts are cached: call invalidate_prepared() after an
        update (predict_batched does)."""
        kind, enc = self.encoder_kind, self.encoder
        if kind == "htsat":
            h = enc(x, None, mm_dtype, False, impl)
        elif kind == "gt":
            h = mae_forward_feature_fused(enc, x, mm_dtype, False, impl)
        elif kind == "audiomae":
            h = audiomae_backbone_fused(enc, x, mm_dtype, False, impl)
        elif kind == "efficientnet":
            h = enc(x, None, None if mm_dtype == torch.float32 else mm_dtype)
        elif kind in ("clap", "clap2023"):
            h = enc(x, self._lengths(x))
        else:
            h = enc(x)["cls"]
        return self.head(h.to(torch.float32))


@dataclasses.dataclass
class FTResult:
    test_auc: float
    valid_auc: float
    best_epoch: int
    stopped_epoch: int
    metrics: Dict[str, object]
    state_dict: Dict[str, torch.Tensor]  # the best weights, on the CPU


def train_impl(compute_dtype: Optional[torch.dtype], fused_train: Optional[bool],
               device: torch.device, param_sharding: Optional[str] = None, mesh=None) -> str:
    """The encoder blocks' route (ops.swin_train / ops.vit_train impl):
    "kernel" with fused_train (None: on a card in bf16) — the CUDA kernels
    for CUDA tensors (the HTS-AT's K8 and the operaGT / Audio-MAE ViT
    blocks' K9, each in bf16 or float32; the predict batches on the eval
    kernels of the same dtype), their plain versions with the explicit
    backward for CPU tensors (the JAX fused path's interpret mode); else
    "plain" in bf16
    and torch "autograd" in float32 (the JAX flax path). param_sharding
    (ZeRO-3, megatron) and a 2-D mesh keep the plain path; fused_train=True
    there is a ValueError (parallel/mesh.py::plain_only)."""
    if plain_only(mesh, fused_train, param_sharding):
        fused_train = False
    bf16 = compute_dtype == torch.bfloat16
    if fused_train is None:
        fused_train = device.type == "cuda" and bf16
    if fused_train:
        return "kernel"
    return "plain" if bf16 else "autograd"


def ft_loss(model: EncoderClassifier, xb: torch.Tensor, yb: torch.Tensor, valid: torch.Tensor,
            cw: torch.Tensor, gen: Optional[torch.Generator], mm_dtype: torch.dtype, impl: str,
            l2_strength: float, mesh=None, w_total: Optional[torch.Tensor] = None):
    """The fine-tuning loss of one batch (finetune.py:376-386): (loss, new
    BatchNorm statistics or None). mesh: xb, yb, valid are this rank's rows
    and the loss is the rank's share, (ce * w).sum() over w_total (the
    global batch's w.sum()) plus the L2 terms over n, the data axis's
    length (parallel/tensor.py::sq_sum counts a tensor-parallel model's
    shards once)."""
    h, stats = model.encode_train(xb, gen, mm_dtype, impl, mesh)
    logits = model.head(h) + 1e-10
    ce = -torch.log_softmax(logits, dim=-1).gather(1, yb[:, None])[:, 0]
    w = cw[yb] * valid
    loss = (ce * w).sum() / torch.clamp(w.sum() if w_total is None else w_total, min=1e-12)
    sq = lambda m: tensor.sq_sum(list(m.parameters()), list(m.parameters()))
    l2 = l2_strength * sq(model.head) + 0.2 * l2_strength * sq(model.encoder)
    return loss + l2 / data_size(mesh), stats


def trainable_params(model: EncoderClassifier, freeze_encoder: str):
    pred = freeze_mask_fn(freeze_encoder, model.encoder_kind)
    return [p for name, p in model.named_parameters() if pred(name)]


def train_step(model: EncoderClassifier, opt: ClippedAdam, xb, yb, valid, cw,
               gen: Optional[torch.Generator], mm_dtype: torch.dtype, impl: str,
               l2_strength: float, aug: Optional[Tuple[int, int]] = None, mesh=None,
               zero: Optional[ZeroShard] = None, rank_gen: Optional[torch.Generator] = None):
    """One fine-tuning step: SpecAugment (aug = (time, freq) drop widths,
    two stripes each), the loss, gradients of opt's parameters, the update;
    the BatchNorms' running statistics take the step's. Returns (the loss,
    the gradients before clipping).

    mesh: xb, yb, valid are the global batch; SpecAugment draws for all of
    it from gen, the rank runs its rows with rank_gen's dropout / DropPath,
    and the gradients are the summed shares (the loss returned is the
    global one). zero: ZeRO-3, opt over zero.shard (the gradients returned
    are the rank's shard of the sums)."""
    if aug is not None:
        xb = augment.spec_augment(xb, gen, aug[0], 2, aug[1], 2)
    w_total = None
    if mesh is not None:
        w_total = (cw[yb] * valid).sum()
        rows = local_rows(xb.shape[0], mesh)
        xb, yb, valid = xb[rows], yb[rows], valid[rows]
    if zero is not None:
        zero.gather()
    loss, stats = ft_loss(model, xb, yb, valid, cw, rank_gen or gen, mm_dtype, impl,
                          l2_strength, mesh, w_total)
    grads = torch.autograd.grad(loss, zero.params if zero is not None else opt.params)
    if zero is not None:
        grads = [zero.reduce_grads(grads)]
        zero.release()
    elif mesh is not None:
        grads = tensor.reduce_slices(opt.params, grads)
        grads = all_reduce_grads(opt.params, mesh, grads)
    opt.step(grads)
    if stats:
        bn_mod.commit(stats)
    loss = loss.detach()
    return (loss if mesh is None else all_reduce_sum(loss, mesh)), grads


def predict_batched(model: EncoderClassifier, x: np.ndarray, mm_dtype: torch.dtype,
                    impl: str, device, bs: int = 64) -> np.ndarray:
    """Softmax probabilities of x in batches of bs, a short tail padded with
    repeats of its first row (finetune.py:433-443)."""
    outs = []
    model.invalidate_prepared()
    for i in range(0, len(x), bs):
        chunk = np.asarray(x[i: i + bs], np.float32)
        n = len(chunk)
        if n < bs:
            chunk = np.concatenate([chunk, np.repeat(chunk[:1], bs - n, axis=0)], axis=0)
        xb = torch.from_numpy(chunk).to(device)
        outs.append(torch.softmax(model(xb, mm_dtype, impl), -1).cpu().numpy()[:n])
    return np.concatenate(outs, axis=0)


def finetune_classifier(
    x_train: np.ndarray,
    y_train: np.ndarray,
    x_val: np.ndarray,
    y_val: np.ndarray,
    x_test: Optional[np.ndarray] = None,
    y_test: Optional[np.ndarray] = None,
    *,
    encoder_kind: str = "htsat",
    init_state: Optional[Mapping[str, torch.Tensor]] = None,
    n_cls: int = 2,
    head: str = "linear",
    feat_dim: int = 768,
    lr: float = 1e-4,
    l2_strength: float = 1e-4,
    epochs: int = 64,
    batch_size: int = 64,
    class_weights: Optional[np.ndarray] = None,
    freeze_encoder: str = "none",
    spec_augment: bool = False,
    time_drop_width: int = 40,
    freq_drop_width: int = 8,
    patience: int = 10,
    min_delta: float = 1e-3,
    lr_decay: float = 0.99,
    grad_clip: float = 1.0,
    seed: int = 0,
    metrics: Sequence[str] = HEART_METRICS,
    dataset: Optional[str] = None,
    task: Optional[str] = None,
    annotations_test: Optional[np.ndarray] = None,
    htsat_config: Optional[HTSATConfig] = None,
    mae_config: Optional[vit_mae.MAEConfig] = None,
    compute_dtype: Optional[torch.dtype] = None,
    mesh=None,
    param_sharding: Optional[str] = None,
    fused_train: Optional[bool] = None,
    device="cuda",
    on_epoch: Optional[Callable[[int, float], None]] = None,
) -> FTResult:
    """Fine-tune encoder + head (see the module doc). init_state: starting
    weights by name (a whole classifier, e.g. from_jax_classifier of a JAX
    init, or a pretrained "encoder.*" subset); default the seeded random
    init (torch.Generator(seed)). compute_dtype torch.bfloat16 is the bf16
    flow, else strict float32. on_epoch(epoch, valid AUROC) is called after
    each epoch. mesh: this rank's DataParallelMesh or TensorParallelMesh
    (the run takes the mesh's device; batch_size must divide over its data
    axis); param_sharding: "fsdp" (ZeRO-3), "megatron" (2-D mesh) or None
    (see the module doc)."""
    mesh = check_mesh(mesh)
    param_sharding = check_param_sharding(mesh, param_sharding)
    if batch_size % data_size(mesh):
        raise ValueError(f"batch_size {batch_size} not divisible by data axis {data_size(mesh)}")
    dev = mesh.device if mesh is not None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("finetune_classifier(device='cuda'): no CUDA card available")
    mm_dtype = torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32
    impl = train_impl(compute_dtype, fused_train, dev, param_sharding, mesh)
    eval_impl = "kernel" if impl == "kernel" else "plain"

    model = EncoderClassifier(encoder_kind, n_cls, head, feat_dim, htsat_config, mae_config,
                              torch.Generator().manual_seed(seed))
    if init_state is not None:
        own = model.state_dict()
        unknown = [k for k in init_state if k not in own]
        if unknown:
            raise KeyError(f"init_state holds names the classifier lacks, e.g. {unknown[:3]}")
        own.update({k: torch.as_tensor(v) for k, v in init_state.items()})
        model.load_state_dict(own)
    model.to(dev).train()
    if param_sharding == "megatron":
        tensor.shard_model(model, mesh)
    nb = (len(x_train) + batch_size - 1) // batch_size
    zero = None
    if param_sharding == "fsdp":
        zero, opt = shard_params_and_opt(
            trainable_params(model, freeze_encoder), mesh,
            lambda ps: ClippedAdam(ps, nb, lr, lr_decay, grad_clip, optax_clip=True,
                                   shard_mesh=mesh.model if is_2d(mesh) else mesh))
    else:
        opt = ClippedAdam(trainable_params(model, freeze_encoder), nb, lr, lr_decay, grad_clip,
                          optax_clip=True)
    cw = torch.as_tensor(
        class_weights if class_weights is not None else np.ones(n_cls, np.float32),
        dtype=torch.float32, device=dev)
    X = torch.as_tensor(np.asarray(x_train, np.float32), device=dev)
    Y = torch.as_tensor(np.asarray(y_train).astype(np.int64), device=dev)
    perms = torch.as_tensor(_make_perms(np.random.default_rng(seed), len(x_train), batch_size,
                                        epochs), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    rank_gen = None if mesh is None else rank_generator(seed + 7, mesh, dev)
    aug = (time_drop_width, freq_drop_width) if spec_augment else None

    from .checkpoints import EarlyStopping

    es = EarlyStopping("max", min_delta, patience)
    best_auc, best_epoch, best = -1.0, -1, copy.deepcopy(tensor.state_dict(model))
    if zero is not None:
        zero.release()
    stopped = epochs - 1
    with strict_f32():
        for e in range(epochs):
            for idx in perms[e]:
                xb, yb = X[idx.clamp(min=0)], Y[idx.clamp(min=0)]
                valid = (idx >= 0).to(torch.float32)
                train_step(model, opt, xb, yb, valid, cw, gen, mm_dtype, impl, l2_strength, aug,
                           mesh, zero, rank_gen)
            if zero is not None:
                zero.gather()  # the whole model for the predictions and the best weights
            vauc = M.auroc(y_val, predict_batched(model, x_val, mm_dtype, eval_impl, dev),
                           n_cls, "macro")
            vauc = broadcast_value(vauc, mesh)  # rank 0's AUROC decides for every rank
            if on_epoch is not None:
                on_epoch(e, vauc)
            if vauc > best_auc:
                best_auc, best_epoch, best = vauc, e, copy.deepcopy(tensor.state_dict(model))
            if es.step(vauc):
                stopped = e
                break
            if zero is not None:
                zero.release()
        if zero is not None:
            zero.gather()
        tensor.load_state_dict(model, best)
        result_metrics: Dict[str, object] = {}
        test_auc = float("nan")
        if x_test is not None and len(x_test):
            probs_t = predict_batched(model, x_test, mm_dtype, eval_impl, dev)
            test_auc = M.auroc(y_test, probs_t, n_cls, "macro")
            result_metrics = M.compute_metrics(metrics, y_test, probs_t.argmax(axis=1), probs_t,
                                               n_cls, dataset, task, annotations_test)
            result_metrics["test_auc"] = test_auc
    return FTResult(test_auc=test_auc, valid_auc=best_auc, best_epoch=best_epoch,
                    stopped_epoch=stopped, metrics=result_metrics,
                    state_dict={k: v.detach().cpu() for k, v in best.items()})


# ---------------------------------------------------------------------------
# feature-dir entry point (finetune_heart :880-1360)
# ---------------------------------------------------------------------------


def build_ft_spectrogram_cache(feature_dir: str, pretrain: str) -> np.ndarray:
    """Create or load the cached first-window inputs (finetuning.py:967-980,
    1064-1078, 1120-1138; the JAX finetune.py:497-548): fbank_audiomae.npy
    (Audio-MAE), clap_audio_<version>.npy (each file's CLAP clip,
    models/clap.py::load_clap_clip with one np.random.default_rng(0) over
    the files, cut to whole hops), fbank_hear.npy (the first 2-s waveform
    window at 16 kHz) or spectrogram_pad8.npy (the OPERA encoders)."""
    from ..audio import pipelines

    files = lambda: np.load(os.path.join(feature_dir, "sound_dir_loc.npy"))
    if "audiomae" in pretrain:
        cache = os.path.join(feature_dir, "fbank_audiomae.npy")
        if not os.path.exists(cache):
            x = [pipelines.get_split_signal_fbank_pad(str(f), input_sec=10)[0] for f in files()]
            np.save(cache, np.asarray(x))
        return np.load(cache)
    if "clap" in pretrain:
        cfg = clap.CLAPConfig(version="2023" if "2023" in pretrain else "2022")
        cache = os.path.join(feature_dir, f"clap_audio_{cfg.version}.npy")
        if not os.path.exists(cache):
            rng = np.random.default_rng(0)
            n = int(cfg.duration * cfg.sample_rate) // cfg.hop * cfg.hop
            x = [clap.load_clap_clip(str(f), cfg.duration, cfg.sample_rate, rng)[:n]
                 for f in files()]
            np.save(cache, np.asarray(x))
        return np.load(cache)
    if pretrain == "hear":
        cache = os.path.join(feature_dir, "fbank_hear.npy")
        if not os.path.exists(cache):
            x = [pipelines.get_split_signal_fbank_pad(str(f), input_sec=2, spectrogram=False)[0]
                 for f in files()]
            np.save(cache, np.asarray(x))
        return np.load(cache)
    cache = os.path.join(feature_dir, "spectrogram_pad8.npy")
    if not os.path.exists(cache):
        x = [pipelines.get_split_signal(str(f), input_sec=8.18, spectrogram=True)[0]
             for f in files()]
        np.save(cache, np.asarray(x))
    return np.load(cache)


def encoder_kind_of(pretrain: str) -> Tuple[str, int, Optional[int], int, int]:
    """pretrain -> (encoder_kind, feat_dim, batch size override, time and
    frequency SpecAugment widths) (finetune.py:582-602)."""
    if "audiomae" in pretrain:
        return "audiomae", 768, 32, 100, 20
    if "clap" in pretrain:
        return ("clap2023" if "2023" in pretrain else "clap"), 1024, None, 64, 8
    if pretrain == "hear":
        return "hear", 1024, 16, 0, 0
    if "GT" in pretrain or pretrain == "operaGT":
        return "gt", 384, None, 40, 8
    if "operaCE" in pretrain or pretrain == "null":
        return "efficientnet", 1280, None, 40, 8
    return "htsat", 768, None, 40, 8


def pretrained_encoder_state(pretrain: str, encoder_kind: str,
                             ckpt_path: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The pretrained encoder's weights as "encoder.*" names of the
    classifier (extract/registry.py's checkpoints: the Cola encoders'
    subtrees, the CLAP tower from an msclap state_dict, HeAR from a
    google/hear-pytorch one)."""
    from ..extract import registry

    model = registry.initialize_pretrained_model(pretrain, ckpt_path=ckpt_path)
    enc = {"htsat": lambda: model.htsat, "efficientnet": lambda: model.encoder}.get(
        encoder_kind, lambda: model)()
    return {f"encoder.{k}": v for k, v in enc.state_dict().items()}


def ckpt_name(head: str, pretrain: str, batch_size: int, lr: float, epochs: int,
              l2_strength: float, seed: int, freeze_encoder: str, loss: str) -> str:
    """The JAX package's checkpoint stem (finetune.py:688-695)."""
    name = "_".join(["finetuning", head, pretrain, str(batch_size), str(lr), str(epochs),
                     str(l2_strength), str(seed)])
    if freeze_encoder == "early":
        name += "_early"
    if loss == "weighted":
        name += "_weighted"
    return name


def finetune_heart(
    seed: int,
    pretrain: str = "operaCT",
    l2_strength: float = 1e-4,
    epochs: int = 64,
    batch_size: int = 64,
    lr: float = 1e-4,
    head: str = "linear",
    loss: str = "unweighted",
    feat_dim: int = 768,
    dataset_name: str = "circor",
    task: str = "murmurs",
    feature_dir: str = "feature/circor_eval/",
    labels_filename: str = "murmurs.npy",
    freeze_encoder: str = "none",
    spec_augment: bool = False,
    random_init: bool = False,
    ckpt_path: Optional[str] = None,
    compute_dtype: Optional[torch.dtype] = None,
    mesh=None,
    param_sharding: Optional[str] = None,
    fused_train: Optional[bool] = None,
    device="cuda",
) -> FTResult:
    """Fine-tune one seed on a processed heart task (feature_dir holds the
    processors' sound_dir_loc, labels and split) and save the best weights
    as a state_dict .pt under the JAX name stem in cks/finetune/. CLAP and
    HeAR need converted weights (ckpt_path: an msclap or google/hear-pytorch
    state_dict) unless random_init, as in the JAX package (finetune.py:
    605-630); the other kinds load the registry's checkpoint (operaCE:
    cks/model/encoder-operaCE.ckpt) unless random_init or pretrain=null."""
    encoder_kind, feat_dim, bs, tdw, fdw = encoder_kind_of(pretrain)
    if (not random_init and encoder_kind in ("clap", "clap2023", "hear")
            and ckpt_path is None):
        raise FileNotFoundError(
            f"{pretrain} fine-tuning needs converted weights; pass ckpt_path= (an msclap or "
            "google/hear-pytorch state_dict) or random_init=True")
    mesh = check_mesh(mesh)
    param_sharding = check_param_sharding(mesh, param_sharding)
    batch_size = bs or batch_size
    if batch_size % data_size(mesh):  # before the cache is built
        raise ValueError(f"batch_size {batch_size} not divisible by data axis {data_size(mesh)}")
    init_state = None  # the weights first: a missing checkpoint fails before the cache
    if not random_init and pretrain != "null":
        init_state = pretrained_encoder_state(pretrain, encoder_kind, ckpt_path)
    y_label = np.load(os.path.join(feature_dir, labels_filename))
    y_set = np.load(os.path.join(feature_dir, "train_test_split.npy"))
    valid = ~np.isnan(np.asarray(y_label, np.float64))
    y_label = y_label[valid].astype(np.int32)
    y_set = np.asarray(y_set)[valid]
    n_cls = len(set(y_label.tolist()))
    if mesh is not None and mesh.rank != 0:
        mesh.barrier()  # rank 0 builds the cache first
    x_data = build_ft_spectrogram_cache(feature_dir, pretrain)[valid]
    if mesh is not None and mesh.rank == 0:
        mesh.barrier()

    tr, va, te = y_set == "train", y_set == "val", y_set == "test"
    cw = get_class_weights(y_label[tr], n_cls) if loss == "weighted" else None
    ann = None
    if dataset_name == "physionet16":
        ann_all = np.load(os.path.join(feature_dir, "annotations.npy")).astype(np.int32)
        ann = ann_all[valid][te]

    # wandb project Heart-Sound-Analysis-FT (finetuning.py:897-902); no-ops
    # unless WANDB_API_KEY / WANDB_MODE is configured
    from ..utils.logging import WandbLogger, get_run_name

    wandb = WandbLogger(
        "Heart-Sound-Analysis-FT" if mesh is None or mesh.rank == 0 else None,
        get_run_name(f"{pretrain}-{dataset_name}-{task}-{head}"),
        config=dict(
            n_cls=n_cls, pretrain=pretrain, l2_strength=l2_strength, epochs=epochs,
            batch_size=batch_size, lr=lr, head=head, seed=seed, dataset=dataset_name,
            task=task, freeze_encoder=freeze_encoder, loss=loss, spec_augment=spec_augment,
        ),
    )
    res = finetune_classifier(
        x_data[tr], y_label[tr], x_data[va], y_label[va], x_data[te], y_label[te],
        encoder_kind=encoder_kind, init_state=init_state, n_cls=n_cls, head=head,
        feat_dim=feat_dim, lr=lr, l2_strength=l2_strength, epochs=epochs,
        batch_size=batch_size, class_weights=cw, freeze_encoder=freeze_encoder,
        spec_augment=spec_augment, time_drop_width=tdw, freq_drop_width=fdw, seed=seed,
        dataset=dataset_name, task=task, annotations_test=ann, compute_dtype=compute_dtype,
        mesh=mesh, param_sharding=param_sharding, fused_train=fused_train, device=device,
    )
    ck_dir = f"cks/finetune/{dataset_name}_{task}/" if task else f"cks/finetune/{dataset_name}"
    name = ckpt_name(head, pretrain, batch_size, lr, epochs, l2_strength, seed, freeze_encoder,
                     loss)
    from .checkpoints import save_params, written

    written(mesh, lambda: save_params(os.path.join(
        ck_dir, f"{name}-epoch={res.best_epoch:02d}-valid_auc={res.valid_auc:.2f}.pt"),
        res.state_dict))
    wandb.log({"test_auc": res.test_auc})
    wandb.finish()
    return res
