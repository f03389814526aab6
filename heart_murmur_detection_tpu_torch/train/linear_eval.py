"""Linear-probe evaluation harness — counterpart of
heart_murmur_detection_tpu/train/linear_eval.py (`get_class_weights` :38,
`_make_perms` :55, `train_linear_head` :109, `load_feature_split` :187,
`linear_evaluation_heart` :208, `linear_evaluation_heart_cv` :295,
`train_regression_head` :339, `run_seeds` :438; the reference's
src/benchmark/linear_eval.py).

The protocol, step for step as the JAX package runs it:
- an epoch is `_make_perms`' batches: a fresh permutation of the train set
  padded with -1 to whole batches; padded rows weigh 0 (no drop_last);
- loss: softmax cross entropy of logits + 1e-10, weighted per class
  (inverse-frequency weights with loss="weighted", else ones) and divided
  by the sum of the batch's weights, plus l2_strength * sum(p^2) over every
  head parameter, biases included;
- gradients clipped by global norm (grad_clip) before Adam;
- Adam as optax.scale_by_adam (b1 0.9, b2 0.999, eps 1e-8 outside the
  square root, bias corrections in float32), step lr * decay^(count // nb)
  with count the step count across epochs;
- after each epoch the macro validation AUROC, the best epoch by strict >,
  its parameters kept; test metrics (compute_metrics over HEART_METRICS)
  from that head.
The whole train set lives on the device and each step is a few small
kernels with no host sync; the probe runs on the card unless the caller
passes device="cpu".

`train_regression_head` is the LOOCV tasks' regression probe (LinearHeadR,
models_eval.py:1691-1831): the same batches, L2 and decay, the head's
output denormalised by the train targets' mean and std, a masked MSE,
optax's clip_by_global_norm (t / norm * clip past the clip), the best epoch
by validation MAE (strict <) and the reference's early stopping.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.heads import Head
from ..parallel import tensor
from ..parallel.mesh import all_reduce_sum
from . import metrics as M
from .metrics import STANDARD_METRICS

HEART_METRICS = STANDARD_METRICS + [
    "circor_weighted_murmur_acc",
    "circor_weighted_outcome_acc",
    "circor_outcome_cost",
    "physionet16_score",
]
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def get_class_weights(labels: np.ndarray, n_cls: int) -> np.ndarray:
    """Inverse-frequency weights, normalized to sum 1 (linear_eval.py:93-102)."""
    counts = np.bincount(labels, minlength=n_cls).astype(np.float64)
    freqs = counts / counts.sum()
    w = 1.0 / freqs
    return (w / w.sum()).astype(np.float32)


@dataclasses.dataclass
class LPResult:
    test_auc: float
    valid_auc: float
    best_epoch: int
    metrics: Dict[str, object]
    params: Dict[str, torch.Tensor]  # the best head's state_dict, on the CPU


def _make_perms(rng: np.random.Generator, n: int, bs: int, epochs: int) -> np.ndarray:
    """(epochs, nb, bs) train indices, -1 past n: the JAX package's batches."""
    nb = (n + bs - 1) // bs
    out = np.full((epochs, nb * bs), -1, dtype=np.int32)
    for e in range(epochs):
        out[e, :n] = rng.permutation(n)
    return out.reshape(epochs, nb, bs)


class ClippedAdam:
    """Global-norm clipping, then optax.scale_by_adam (b1 0.9, b2 0.999, eps
    1e-8 outside the square root, bias-corrected), then the step lr *
    decay^(count // steps_per_epoch), count the updates already made: the
    probes' and fine-tuning's optimizer. As optax forms them, the bias
    corrections and the decayed lr are float32 (1 - float32(0.999)^count is
    1.3e-5 from 1 - 0.999 at count 1) and the lr scales the update after
    the division by the root. Updates `params` in place.

    optax_clip: optax.clip_by_global_norm's t / norm * clip once the norm
    reaches clip, as fine-tuning and the regression probe clip (JAX
    finetune.py:211, linear_eval.py:383); otherwise train_linear_head's
    t * min(1, clip / max(norm, 1e-12)) (JAX linear_eval.py:89-91).

    shard_mesh: `params` are this rank's ZeRO-3 shard (parallel/mesh.py::
    ZeroShard; the axis it lies on), so the global norm sums the gradients'
    squares over the ranks. Parameters placed on a tensor axis
    (parallel/tensor.py) count each shard once."""

    def __init__(self, params, steps_per_epoch: int, lr: float, decay: float, grad_clip: float,
                 optax_clip: bool = False, shard_mesh=None):
        self.shard_mesh = shard_mesh
        self.params = list(params)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.nb, self.lr, self.decay, self.clip = steps_per_epoch, lr, decay, grad_clip
        self.optax_clip = optax_clip
        self.count = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        sq = tensor.sq_sum(grads, self.params)
        if self.shard_mesh is not None:
            sq = all_reduce_sum(sq, self.shard_mesh)
        gnorm = torch.sqrt(sq)
        if self.optax_clip:
            keep = gnorm < self.clip
            g = [torch.where(keep, x, x / gnorm * self.clip) for x in grads]
        else:
            g = torch._foreach_mul(
                list(grads), torch.clamp(self.clip / torch.clamp(gnorm, min=1e-12), max=1.0))
        f32 = np.float32
        lr_t = float(f32(self.lr) * f32(self.decay) ** f32(self.count // self.nb))
        self.count += 1
        c1 = float(f32(1) - f32(ADAM_B1) ** f32(self.count))
        c2 = float(f32(1) - f32(ADAM_B2) ** f32(self.count))
        torch._foreach_mul_(self.mu, ADAM_B1)
        torch._foreach_add_(self.mu, torch._foreach_mul(g, 1.0 - ADAM_B1))
        torch._foreach_mul_(self.nu, ADAM_B2)
        sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(sq, 1.0 - ADAM_B2)
        torch._foreach_add_(self.nu, sq)
        upd = torch._foreach_div(self.mu, c1)
        den = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, lr_t)
        torch._foreach_sub_(self.params, upd)


def _predict(head: Head, x: torch.Tensor) -> np.ndarray:
    with torch.no_grad():
        return torch.softmax(head(x), dim=-1).cpu().numpy()


def train_linear_head(
    x_train: np.ndarray,
    y_train: np.ndarray,
    x_val: np.ndarray,
    y_val: np.ndarray,
    x_test: Optional[np.ndarray] = None,
    y_test: Optional[np.ndarray] = None,
    *,
    n_cls: int,
    head: str = "linear",
    lr: float = 1e-4,
    l2_strength: float = 1e-5,
    epochs: int = 64,
    batch_size: int = 32,
    class_weights: Optional[np.ndarray] = None,
    lr_decay: float = 0.97,
    grad_clip: float = 1.0,
    seed: int = 0,
    metrics: Sequence[str] = (),
    dataset: Optional[str] = None,
    task: Optional[str] = None,
    annotations_test: Optional[np.ndarray] = None,
    device="cuda",
) -> LPResult:
    """Train a probe head on features (see the module doc): N(0, 0.01)
    initial weights from a torch generator seeded with `seed`, the batches
    from np.random.default_rng(seed)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_linear_head(device='cuda'): no CUDA card available")
    feat_dim = x_train.shape[1]
    nb = (len(x_train) + batch_size - 1) // batch_size
    model = Head(n_cls, head, feat_dim, generator=torch.Generator().manual_seed(seed)).to(dev)
    params = list(model.parameters())
    opt = ClippedAdam(params, nb, lr, lr_decay, grad_clip)

    cw = torch.as_tensor(
        class_weights if class_weights is not None else np.ones(n_cls, np.float32),
        dtype=torch.float32, device=dev,
    )
    X = torch.as_tensor(np.asarray(x_train, np.float32), device=dev)
    Y = torch.as_tensor(np.asarray(y_train).astype(np.int64), device=dev)
    Xv = torch.as_tensor(np.asarray(x_val, np.float32), device=dev)
    perms = torch.as_tensor(
        _make_perms(np.random.default_rng(seed), len(x_train), batch_size, epochs), device=dev
    )

    best_auc, best_epoch, best_state = -1.0, -1, copy.deepcopy(model.state_dict())
    for e in range(epochs):
        for idx in perms[e]:
            xb, yb = X[idx.clamp(min=0)], Y[idx.clamp(min=0)]
            valid = (idx >= 0).to(torch.float32)
            logits = model(xb) + 1e-10
            ce = -torch.log_softmax(logits, dim=-1).gather(1, yb[:, None])[:, 0]
            w = cw[yb] * valid
            loss = (ce * w).sum() / torch.clamp(w.sum(), min=1e-12)
            loss = loss + l2_strength * sum((p * p).sum() for p in params)
            opt.step(torch.autograd.grad(loss, params))
        vauc = M.auroc(y_val, _predict(model, Xv), n_cls, "macro")
        if vauc > best_auc:
            best_auc, best_epoch = vauc, e
            best_state = copy.deepcopy(model.state_dict())

    model.load_state_dict(best_state)
    result_metrics: Dict[str, object] = {}
    test_auc = float("nan")
    if x_test is not None:
        probs_t = _predict(model, torch.as_tensor(np.asarray(x_test, np.float32), device=dev))
        y_pred = probs_t.argmax(axis=1)
        test_auc = M.auroc(y_test, probs_t, n_cls, "macro")
        result_metrics = M.compute_metrics(
            metrics, y_test, y_pred, probs_t, n_cls, dataset, task, annotations_test
        )
        result_metrics["test_auc"] = test_auc
    return LPResult(
        test_auc=test_auc,
        valid_auc=best_auc,
        best_epoch=best_epoch,
        metrics=result_metrics,
        params={k: v.detach().cpu() for k, v in best_state.items()},
    )


# ---------------------------------------------------------------------------
# feature-dir entry points (linear_evaluation_heart :1354-1540)
# ---------------------------------------------------------------------------


def load_feature_split(feature_dir: str, use_feature: str, labels_filename: str):
    y_set = np.load(os.path.join(feature_dir, "train_test_split.npy"))
    y_label = np.load(os.path.join(feature_dir, labels_filename))
    # 'name_old' loads the reference's renamed legacy caches
    # (<name>_feature_old.npy, e.g. operaCT768_feature_old.npy)
    if use_feature.endswith("_old"):
        fname = use_feature[: -len("_old")] + "_feature_old.npy"
    else:
        fname = use_feature + "_feature.npy"
    x_data = np.load(os.path.join(feature_dir, fname)).squeeze()
    valid = ~np.isnan(np.asarray(y_label, dtype=np.float64))
    x_data = x_data[valid]
    y_label = y_label[valid].astype(np.int32)
    y_set = np.asarray(y_set)[valid]
    return x_data, y_label, y_set, valid


def linear_evaluation_heart(
    seed: int,
    use_feature: str = "operaCE1280",
    l2_strength: float = 1e-5,
    epochs: int = 64,
    batch_size: int = 32,
    lr: float = 1e-4,
    head: str = "linear",
    loss: str = "unweighted",
    dataset_name: str = "circor",
    task: str = "murmurs",
    feature_dir: str = "feature/circor_eval/",
    labels_filename: str = "murmurs.npy",
    save_ckpt_dir: Optional[str] = None,
    device="cuda",
) -> LPResult:
    x_data, y_label, y_set, valid = load_feature_split(
        feature_dir, use_feature, labels_filename
    )
    n_cls = len(set(y_label.tolist()))

    tr, va, te = y_set == "train", y_set == "val", y_set == "test"
    ann = None
    if dataset_name == "physionet16":
        ann_all = np.load(os.path.join(feature_dir, "annotations.npy")).astype(np.int32)
        ann = ann_all[valid][te]

    # wandb project Heart-Sound-Analysis (linear_eval.py:1491-1512); no-ops
    # unless WANDB_API_KEY / WANDB_MODE is configured
    from ..utils.logging import WandbLogger, get_run_name

    wandb = WandbLogger(
        "Heart-Sound-Analysis",
        get_run_name(f"{use_feature}-{dataset_name}-{task}-{head}"),
        config=dict(
            n_cls=n_cls, use_feature=use_feature, l2_strength=l2_strength,
            epochs=epochs, batch_size=batch_size, lr=lr, head=head,
            dataset=dataset_name, task=task, seed=seed,
            gradient_clip_val=1.0, loss=loss,
        ),
    )

    cw = get_class_weights(y_label[tr], n_cls) if loss == "weighted" else None
    res = train_linear_head(
        x_data[tr], y_label[tr], x_data[va], y_label[va], x_data[te], y_label[te],
        n_cls=n_cls, head=head, lr=lr, l2_strength=l2_strength, epochs=epochs,
        batch_size=batch_size, class_weights=cw, seed=seed, metrics=HEART_METRICS,
        dataset=dataset_name, task=task, annotations_test=ann, device=device,
    )
    if save_ckpt_dir:
        from .checkpoints import save_params

        name = "_".join(
            [head, use_feature, str(batch_size), str(lr), str(epochs), str(l2_strength), str(seed)]
        )
        if loss == "weighted":  # disambiguates ckpts (eval_ckpts.py:78)
            name += "_weighted"
        save_params(
            os.path.join(
                save_ckpt_dir,
                f"{name}-epoch={res.best_epoch:02d}-valid_auc={res.valid_auc:.2f}.pt",
            ),
            res.params,
        )
    wandb.log({"test_auc": res.test_auc, **M.expand_per_class(res.metrics, dataset_name, task)})
    wandb.finish()
    return res


def linear_evaluation_heart_cv(
    seed: int,
    use_feature: str,
    feature_dir: str,
    labels_filename: str,
    n_splits: int = 5,
    device="cuda",
    **kw,
) -> List[float]:
    """5-fold stratified CV over the train split (linear_eval.py:1543-1698)."""
    from ..data.splits import stratified_kfold

    x_data, y_label, y_set, _ = load_feature_split(feature_dir, use_feature, labels_filename)
    x_tr, y_tr = x_data[y_set == "train"], y_label[y_set == "train"]
    n_cls = len(set(y_tr.tolist()))
    scores = []
    for tr_idx, va_idx in stratified_kfold(y_tr, n_splits, seed):
        cw = (
            get_class_weights(y_tr[tr_idx], n_cls)
            if kw.get("loss", "unweighted") == "weighted"
            else None
        )
        res = train_linear_head(
            x_tr[tr_idx], y_tr[tr_idx], x_tr[va_idx], y_tr[va_idx], x_tr[va_idx], y_tr[va_idx],
            n_cls=n_cls,
            head=kw.get("head", "linear"),
            lr=kw.get("lr", 1e-4),
            l2_strength=kw.get("l2_strength", 1e-5),
            epochs=kw.get("epochs", 64),
            batch_size=kw.get("batch_size", 32),
            class_weights=cw,
            seed=seed,
            device=device,
        )
        scores.append(res.test_auc)
    return scores


def _on(x, dev: torch.device) -> torch.Tensor:
    """Features or targets as float32 on dev (a tensor already there stays)."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def train_regression_head(
    x_train,
    y_train,
    x_val,
    y_val,
    x_test,
    y_test,
    *,
    head: str = "mlp",
    lr: float = 1e-4,
    l2_strength: float = 1e-1,
    epochs: int = 64,
    batch_size: int = 64,
    lr_decay: float = 0.97,
    grad_clip: float = 1.0,
    seed: int = 0,
    patience: Optional[int] = None,
    min_delta: float = 1e-3,
    device="cuda",
):
    """Regression probe (see the module doc): Head(1) (Linear, or Linear ->
    ReLU -> Linear at feat_dim) with N(0, 0.01) weights from a torch
    generator seeded with `seed`, its output * std + mean of the train
    targets; the batches from np.random.default_rng(seed). Features may be
    numpy arrays or tensors already on the device (the LOOCV loops keep a
    corpus there across folds); targets are numpy. Returns (test MAE, test
    MAPE)."""
    from .checkpoints import EarlyStopping

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_regression_head(device='cuda'): no CUDA card available")
    feat_dim = x_train.shape[1]
    mean = float(np.mean(y_train))
    std = float(np.std(y_train))
    nb = (len(x_train) + batch_size - 1) // batch_size
    model = Head(1, head, feat_dim, generator=torch.Generator().manual_seed(seed)).to(dev)
    params = list(model.parameters())
    opt = ClippedAdam(params, nb, lr, lr_decay, grad_clip, optax_clip=True)
    X, Xv, Xt = _on(x_train, dev), _on(x_val, dev), _on(x_test, dev)
    Y = _on(np.asarray(y_train).reshape(-1, 1), dev)
    perms = torch.as_tensor(
        _make_perms(np.random.default_rng(seed), len(x_train), batch_size, epochs), device=dev
    )

    def predict(x: torch.Tensor) -> np.ndarray:
        with torch.no_grad():
            return (model(x) * std + mean).cpu().numpy().ravel()

    y_val = np.asarray(y_val).ravel()
    best_mae, best_state = np.inf, copy.deepcopy(model.state_dict())
    es = EarlyStopping("min", min_delta, patience)
    for e in range(epochs):
        for idx in perms[e]:
            xb, yb = X[idx.clamp(min=0)], Y[idx.clamp(min=0)]
            valid = (idx >= 0).to(torch.float32)
            pred = model(xb) * std + mean + 1e-10
            se = ((pred - yb) ** 2)[:, 0]
            loss = (se * valid).sum() / torch.clamp(valid.sum(), min=1e-12)
            loss = loss + l2_strength * sum((p * p).sum() for p in params)
            opt.step(torch.autograd.grad(loss, params))
        mae = float(np.mean(np.abs(predict(Xv) - y_val)))
        if mae < best_mae:
            best_mae, best_state = mae, copy.deepcopy(model.state_dict())
        if es.step(mae):
            break
    model.load_state_dict(best_state)
    pt = predict(Xt)
    yt = np.asarray(y_test).ravel()
    test_mae = float(np.mean(np.abs(pt - yt)))
    test_mape = float(np.mean(np.abs((pt - yt) / yt)))
    return test_mae, test_mape


def run_seeds(fn, n_run: int = 5, **kw):
    """The 5-seed mean±std protocol (linear_eval.py:1790-1957)."""
    scores = []
    for seed in range(n_run):
        res = fn(seed=seed, **kw)
        scores.append(res.test_auc if hasattr(res, "test_auc") else res)
    arr = np.asarray(scores, dtype=np.float64)
    return arr, float(arr.mean()), float(arr.std())
