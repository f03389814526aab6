"""Checkpoint re-evaluation — counterpart of
heart_murmur_detection_tpu/train/eval_ckpts.py (`_find_ckpt` :25,
`evaluate_linear_head` :32, `evaluate_finetuned_model` :82; the
reference's src/benchmark/other_eval/eval_ckpts.py).

Reloads the port's best probe heads and fine-tuned models by their
hyperparameter-encoded file names (the JAX name stems with `.pt`, as
train/linear_eval.py::linear_evaluation_heart and
train/finetune.py::finetune_heart write them) and re-tests them, including
cross-task evaluation: an encoder fine-tuned on task A tested on task B's
split (finetuned_dataset_name / finetuned_task, eval_ckpts.py:161-218).

A fine-tuned model is evaluated as the JAX function evaluates it: the
EncoderClassifier in float32 (on a card the plain path with TF32 off; the
EfficientNet of operaCE and null on cuDNN, 1280-d),
batches of 32 with the tail padded by repeats of its first row, softmax,
compute_metrics and the macro test AUROC. Both run on the card unless the
caller passes device="cpu".
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..models.heads import Head
from ..models.htsat import HTSATConfig
from ..utils.precision import strict_f32
from . import metrics as M
from .checkpoints import load_params
from .finetune import EncoderClassifier, build_ft_spectrogram_cache, ckpt_name
from .linear_eval import HEART_METRICS, load_feature_split


def _find_ckpt(ck_dir: str, prefix: str, ext: str = ".pt") -> str:
    cands = sorted(glob.glob(os.path.join(ck_dir, f"{prefix}*{ext}")))
    if not cands:
        raise FileNotFoundError(f"No checkpoint starting with {prefix} in {ck_dir}")
    return cands[0]


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("checkpoint re-evaluation on device='cuda': no CUDA card available")
    return dev


def _annotations(dataset_name: str, feature_dir: str, valid, te):
    if dataset_name != "physionet16":
        return None
    return np.load(os.path.join(feature_dir, "annotations.npy")).astype(np.int32)[valid][te]


def evaluate_linear_head(
    seed: int,
    metrics: Sequence[str] = HEART_METRICS,
    use_feature: str = "operaCE1280",
    l2_strength: float = 1e-5,
    epochs: int = 64,
    batch_size: int = 32,
    lr: float = 1e-4,
    head: str = "linear",
    dataset_name: str = "circor",
    task: str = "murmurs",
    feature_dir: str = "feature/circor_eval/",
    labels_filename: str = "murmurs.npy",
    loss: str = "unweighted",
    ckpt_path: Optional[str] = None,
    device="cuda",
) -> Dict[str, object]:
    """Test metrics of a saved probe head on the feature dir's test split."""
    dev = _device(device)
    x, y, y_set, valid = load_feature_split(feature_dir, use_feature, labels_filename)
    n_cls = len(set(y.tolist()))
    te = y_set == "test"
    x_te, y_te = x[te], y[te]

    if ckpt_path is None:
        ck_dir = (
            f"cks/linear/{dataset_name}_{task}/" if task else f"cks/linear/{dataset_name}"
        )
        prefix = "_".join(
            [head, use_feature, str(batch_size), str(lr), str(epochs), str(l2_strength), str(seed)]
        )
        if loss == "weighted":  # the reference appends this tag (eval_ckpts.py:78)
            prefix += "_weighted"
        ckpt_path = _find_ckpt(ck_dir, prefix)
    model = Head(classes=n_cls, head=head, feat_dim=x.shape[1])
    model.load_state_dict(load_params(ckpt_path))
    model.to(dev).eval()
    with torch.no_grad(), strict_f32():
        logits = model(torch.as_tensor(np.asarray(x_te, np.float32), device=dev))
        probs = torch.softmax(logits, dim=-1).cpu().numpy()
    y_pred = probs.argmax(1)
    ann = _annotations(dataset_name, feature_dir, valid, te)
    out = M.compute_metrics(metrics, y_te, y_pred, probs, n_cls, dataset_name, task, ann)
    out["test_auc"] = M.auroc(y_te, probs, n_cls, "macro")
    return out


def encoder_kind_for_eval(pretrain: str):
    """pretrain -> (encoder_kind, feat_dim), routed as the JAX function
    routes it (eval_ckpts.py:133-140)."""
    if "audiomae" in pretrain:
        return "audiomae", 768
    if "GT" in pretrain:
        return "gt", 384
    if "operaCE" in pretrain or pretrain == "null":
        return "efficientnet", 1280
    return "htsat", 768


def evaluate_finetuned_model(
    seed: int,
    metrics: Sequence[str] = HEART_METRICS,
    pretrain: str = "operaCT",
    l2_strength: float = 1e-4,
    epochs: int = 64,
    batch_size: int = 64,
    lr: float = 1e-4,
    head: str = "linear",
    feat_dim: int = 768,
    dataset_name: str = "circor",
    task: str = "murmurs",
    feature_dir: str = "feature/circor_eval/",
    labels_filename: str = "murmurs.npy",
    freeze_encoder: str = "none",
    loss: str = "weighted",
    finetuned_dataset_name: Optional[str] = None,
    finetuned_task: Optional[str] = None,
    ckpt_path: Optional[str] = None,
    htsat_config: Optional[HTSATConfig] = None,
    device="cuda",
) -> Dict[str, object]:
    """Test metrics of a saved fine-tuned model on the feature dir's test
    split (the first-window spectrogram cache of build_ft_spectrogram_cache).
    feat_dim follows the encoder, as in the JAX function."""
    finetuned_dataset_name = finetuned_dataset_name or dataset_name
    finetuned_task = finetuned_task if finetuned_task is not None else task
    encoder_kind, feat_dim = encoder_kind_for_eval(pretrain)
    if encoder_kind == "htsat":  # flax infers the head's width; torch is told it
        feat_dim = (htsat_config or HTSATConfig()).num_features
    dev = _device(device)

    y_label = np.load(os.path.join(feature_dir, labels_filename))
    y_set = np.load(os.path.join(feature_dir, "train_test_split.npy"))
    valid = ~np.isnan(np.asarray(y_label, np.float64))
    y_label = y_label[valid].astype(np.int32)
    y_set = np.asarray(y_set)[valid]
    n_cls = len(set(y_label.tolist()))
    x_data = build_ft_spectrogram_cache(feature_dir, pretrain)[valid]
    te = y_set == "test"
    x_te, y_te = x_data[te], y_label[te]

    if ckpt_path is None:
        ck_dir = (
            f"cks/finetune/{finetuned_dataset_name}_{finetuned_task}/"
            if finetuned_task
            else f"cks/finetune/{finetuned_dataset_name}"
        )
        prefix = ckpt_name(head, pretrain, batch_size, lr, epochs, l2_strength, seed,
                           freeze_encoder, loss)
        ckpt_path = _find_ckpt(ck_dir, prefix)

    model = EncoderClassifier(encoder_kind, n_cls, head, feat_dim, htsat_config,
                              generator=torch.Generator().manual_seed(0))
    model.load_state_dict(load_params(ckpt_path))
    model.to(dev).eval()
    probs = []
    bs = 32
    with strict_f32():
        for i in range(0, len(x_te), bs):
            chunk = np.asarray(x_te[i: i + bs], np.float32)
            pad = bs - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[:1], pad, 0)], 0)
            logits = model(torch.from_numpy(chunk).to(dev), torch.float32, "plain")
            probs.append(torch.softmax(logits, -1).cpu().numpy()[: bs - pad])
    probs = np.concatenate(probs, axis=0)
    y_pred = probs.argmax(1)
    ann = _annotations(dataset_name, feature_dir, valid, te)
    out = M.compute_metrics(metrics, y_te, y_pred, probs, n_cls, dataset_name, task, ann)
    out["test_auc"] = M.auroc(y_te, probs, n_cls, "macro")
    return out
