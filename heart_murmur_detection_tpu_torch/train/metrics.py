"""Evaluation metric suite — numpy implementations of the torchmetrics set the
reference uses (models_eval.py:238-298) plus the clinical scores
(models_eval.py:22-235). A copy of heart_murmur_detection_tpu/train/
metrics.py (pure numpy, but its package imports JAX); every function is on
the heart probe's path (compute_metrics over HEART_METRICS, auroc,
expand_per_class). tests/test_torch_probe.py pins the copy to the original.

Averaging semantics follow torchmetrics: 'weighted' weights per-class values
by true-class support; 'macro' is the unweighted mean over classes; None
returns the per-class vector. AUROC is one-vs-rest with absent classes
skipped (support weight 0 / excluded from macro), matching torchmetrics'
behavior on missing classes.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# confusion-matrix family
# ---------------------------------------------------------------------------


def confusion_matrix(y_true, y_pred, n_cls: int) -> np.ndarray:
    cm = np.zeros((n_cls, n_cls), dtype=np.int64)
    np.add.at(cm, (np.asarray(y_true, int), np.asarray(y_pred, int)), 1)
    return cm


def _average(per_class: np.ndarray, support: np.ndarray, average: Optional[str]):
    if average is None:
        return per_class
    if average == "macro":
        return float(per_class.mean())
    if average == "weighted":
        tot = support.sum()
        return float((per_class * support).sum() / tot) if tot else 0.0
    raise ValueError(average)


def accuracy(y_true, y_pred, n_cls, average="micro"):
    cm = confusion_matrix(y_true, y_pred, n_cls)
    if average == "micro":
        return float(np.trace(cm) / max(cm.sum(), 1))
    recall_c = np.divide(
        np.diag(cm), cm.sum(1), out=np.zeros(n_cls), where=cm.sum(1) > 0
    )
    # torchmetrics MulticlassAccuracy(average=weighted/macro) == recall average
    return _average(recall_c, cm.sum(1), average)


def recall(y_true, y_pred, n_cls, average=None):
    cm = confusion_matrix(y_true, y_pred, n_cls)
    r = np.divide(np.diag(cm), cm.sum(1), out=np.zeros(n_cls), where=cm.sum(1) > 0)
    return _average(r, cm.sum(1), average)


def precision(y_true, y_pred, n_cls, average=None):
    cm = confusion_matrix(y_true, y_pred, n_cls)
    p = np.divide(np.diag(cm), cm.sum(0), out=np.zeros(n_cls), where=cm.sum(0) > 0)
    return _average(p, cm.sum(1), average)


def specificity(y_true, y_pred, n_cls, average=None):
    cm = confusion_matrix(y_true, y_pred, n_cls)
    total = cm.sum()
    tp = np.diag(cm)
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp
    tn = total - tp - fp - fn
    s = np.divide(tn, tn + fp, out=np.zeros(n_cls), where=(tn + fp) > 0)
    return _average(s, cm.sum(1), average)


def f1(y_true, y_pred, n_cls, average=None):
    cm = confusion_matrix(y_true, y_pred, n_cls)
    tp = np.diag(cm)
    p = np.divide(tp, cm.sum(0), out=np.zeros(n_cls), where=cm.sum(0) > 0)
    r = np.divide(tp, cm.sum(1), out=np.zeros(n_cls), where=cm.sum(1) > 0)
    f = np.divide(2 * p * r, p + r, out=np.zeros(n_cls), where=(p + r) > 0)
    return _average(f, cm.sum(1), average)


# ---------------------------------------------------------------------------
# AUROC (one-vs-rest, rank-based)
# ---------------------------------------------------------------------------


def _binary_auc(score: np.ndarray, pos: np.ndarray) -> float:
    """Mann-Whitney AUC with tie handling (average ranks)."""
    order = np.argsort(score, kind="mergesort")
    ranks = np.empty(len(score), dtype=np.float64)
    s_sorted = score[order]
    i = 0
    r = 1.0
    while i < len(score):
        j = i
        while j + 1 < len(score) and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        ranks[order[i : j + 1]] = (r + r + (j - i)) / 2.0
        r += j - i + 1
        i = j + 1
    n_pos = int(pos.sum())
    n_neg = len(pos) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def auroc(y_true, probs, n_cls: Optional[int] = None, average="macro"):
    """Multiclass OVR AUROC. probs: (N, C). Classes absent from y_true are
    skipped (weight 0), as torchmetrics does."""
    probs = np.asarray(probs, dtype=np.float64)
    y_true = np.asarray(y_true, dtype=int)
    C = probs.shape[1] if n_cls is None else n_cls
    if C == 2 and probs.ndim == 1:
        return _binary_auc(probs, y_true == 1)
    aucs, supports = [], []
    for c in range(C):
        pos = y_true == c
        a = _binary_auc(probs[:, c], pos)
        if not np.isnan(a):
            aucs.append(a)
            supports.append(pos.sum())
    if not aucs:
        return 0.0
    aucs = np.array(aucs)
    supports = np.array(supports, dtype=np.float64)
    if average == "macro":
        return float(aucs.mean())
    if average == "weighted":
        return float((aucs * supports).sum() / supports.sum())
    raise ValueError(average)


# ---------------------------------------------------------------------------
# clinical scores (direct formula ports, cited)
# ---------------------------------------------------------------------------


def physionet16_score(y_pred, y_true, annotations) -> float:
    """SQI-weighted PhysioNet-2016 MACC (models_eval.py:22-97). annotations:
    1=clean, 0=noisy. NORMAL=0, ABNORMAL=1."""
    y_pred = np.asarray(y_pred)
    y_true = np.asarray(y_true)
    ann = np.asarray(annotations)
    normal, abnormal = y_true == 0, y_true == 1
    clean, noisy = ann == 1, ann == 0
    Nn1 = int(((y_pred == 0) & normal & clean).sum())
    Nn2 = int(((y_pred == 0) & normal & noisy).sum())
    An1 = int(((y_pred == 0) & abnormal & clean).sum())
    An2 = int(((y_pred == 0) & abnormal & noisy).sum())
    Na1 = int(((y_pred == 1) & normal & clean).sum())
    Na2 = int(((y_pred == 1) & normal & noisy).sum())
    Aa1 = int(((y_pred == 1) & abnormal & clean).sum())
    Aa2 = int(((y_pred == 1) & abnormal & noisy).sum())
    tn = (normal & clean).sum() + (normal & noisy).sum()
    ta = (abnormal & clean).sum() + (abnormal & noisy).sum()
    wn1 = (normal & clean).sum() / tn if tn else 0.0
    wn2 = (normal & noisy).sum() / tn if tn else 0.0
    wa1 = (abnormal & clean).sum() / ta if ta else 0.0
    wa2 = (abnormal & noisy).sum() / ta if ta else 0.0
    se = 0.0
    sp = 0.0
    if Aa1 + An1 > 0:
        se += wa1 * Aa1 / (Aa1 + An1)
    if Aa2 + An2 > 0:
        se += wa2 * Aa2 / (Aa2 + An2)
    if Nn1 + Na1 > 0:
        sp += wn1 * Nn1 / (Nn1 + Na1)
    if Nn2 + Na2 > 0:
        sp += wn2 * Nn2 / (Nn2 + Na2)
    return float((se + sp) / 2.0)


def circor_weighted_murmur_acc(y_pred, y_true) -> float:
    """5/3/1-weighted murmur accuracy (models_eval.py:99-139).
    0=Absent, 1=Present, 2=Unknown. NB the reference builds its confusion
    matrix as cm[pred, true]."""
    cm = np.zeros((3, 3), dtype=np.int64)
    np.add.at(cm, (np.asarray(y_pred, int), np.asarray(y_true, int)), 1)
    num = 5 * cm[1, 1] + 3 * cm[2, 2] + cm[0, 0]
    den = (
        5 * (cm[1, 1] + cm[2, 1] + cm[0, 1])
        + 3 * (cm[1, 2] + cm[2, 2] + cm[0, 2])
        + (cm[1, 0] + cm[2, 0] + cm[0, 0])
    )
    return float(num / den) if den else 0.0


def circor_weighted_outcome_acc(y_pred, y_true) -> float:
    """5/1-weighted outcome accuracy (models_eval.py:142-176). 0=Abnormal."""
    cm = np.zeros((2, 2), dtype=np.int64)
    np.add.at(cm, (np.asarray(y_true, int), np.asarray(y_pred, int)), 1)
    num = 5 * cm[0, 0] + cm[1, 1]
    den = 5 * (cm[0, 0] + cm[0, 1]) + (cm[1, 0] + cm[1, 1])
    return float(num / den) if den else 0.0


def circor_outcome_cost(y_pred, y_true, task: str = "outcomes") -> float:
    """CirCor challenge screening-cost model (models_eval.py:179-229)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    referral = [1, 2] if task == "murmurs" else [0]
    t = np.isin(y_true, referral)
    p = np.isin(y_pred, referral)
    tp = int((t & p).sum())
    fp = int((~t & p).sum())
    fn = int((t & ~p).sum())
    tn = int((~t & ~p).sum())
    n = tp + fp + fn + tn
    if n == 0:
        return float("nan")
    m = tp + fp
    cost = (
        10 * n
        + (25 + 397 * (m / n) - 1718 * (m / n) ** 2 + 11296 * (m / n) ** 4) * n
        + 10000 * tp
        + 50000 * fn
    )
    return float(cost / n)


# ---------------------------------------------------------------------------
# suite (initialize_metrics equivalent, models_eval.py:238-298)
# ---------------------------------------------------------------------------

STANDARD_METRICS = [
    "weighted_accuracy",
    "weighted_auroc",
    "weighted_specificity",
    "weighted_recall",
    "weighted_precision",
    "weighted_F1",
    "macro_F1",
    "macro_auroc",
    "unweighted_accuracy",
    "unweighted_recall",
    "avg_unweighted_recall",
    "unweighted_specificity",
    "avg_unweighted_specificity",
    "unweighted_precision",
    "avg_unweighted_precision",
]


def compute_metrics(
    metrics: Sequence[str],
    y_true,
    y_pred,
    probs,
    n_cls: int,
    dataset: Optional[str] = None,
    task: Optional[str] = None,
    annotations=None,
) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for m in metrics:
        if m == "weighted_accuracy":
            out[m] = accuracy(y_true, y_pred, n_cls, "weighted")
        elif m == "unweighted_accuracy":
            out[m] = accuracy(y_true, y_pred, n_cls, "micro")
        elif m == "weighted_auroc":
            out[m] = auroc(y_true, probs, n_cls, "weighted")
        elif m == "macro_auroc":
            out[m] = auroc(y_true, probs, n_cls, "macro")
        elif m == "weighted_specificity":
            out[m] = specificity(y_true, y_pred, n_cls, "weighted")
        elif m == "weighted_recall":
            out[m] = recall(y_true, y_pred, n_cls, "weighted")
        elif m == "weighted_precision":
            out[m] = precision(y_true, y_pred, n_cls, "weighted")
        elif m == "weighted_F1":
            out[m] = f1(y_true, y_pred, n_cls, "weighted")
        elif m == "macro_F1":
            out[m] = f1(y_true, y_pred, n_cls, "macro")
        elif m == "unweighted_recall":
            out[m] = recall(y_true, y_pred, n_cls, None)
        elif m == "avg_unweighted_recall":
            out[m] = recall(y_true, y_pred, n_cls, "macro")
        elif m == "unweighted_specificity":
            out[m] = specificity(y_true, y_pred, n_cls, None)
        elif m == "avg_unweighted_specificity":
            out[m] = specificity(y_true, y_pred, n_cls, "macro")
        elif m == "unweighted_precision":
            out[m] = precision(y_true, y_pred, n_cls, None)
        elif m == "avg_unweighted_precision":
            out[m] = precision(y_true, y_pred, n_cls, "macro")
        elif m == "circor_weighted_murmur_acc":
            if dataset == "circor" and task == "murmurs":
                out[m] = circor_weighted_murmur_acc(y_pred, y_true)
        elif m == "circor_weighted_outcome_acc":
            if dataset == "circor" and task == "outcomes":
                out[m] = circor_weighted_outcome_acc(y_pred, y_true)
        elif m == "circor_outcome_cost":
            if dataset == "circor" and task == "outcomes":
                out[m] = circor_outcome_cost(y_pred, y_true)
        elif m == "physionet16_score":
            if dataset == "physionet16" and annotations is not None:
                out[m] = physionet16_score(y_pred, y_true, annotations)
        else:
            print(f"Unsupported metric: {m}")
    return out


def get_int_to_label_mapping(
    dataset: str, task: Optional[str] = None
) -> Optional[Dict[str, str]]:
    """Class-index -> label-name mapping from the feature dir's json
    (models_eval.py:301-317). Returns None when no mapping file exists."""
    import json
    import os

    if dataset == "physionet16":
        path = f"feature/{dataset}_eval/int_to_label.json"
    elif dataset in ("circor", "zchsound_clean", "zchsound_noisy"):
        path = f"feature/{dataset}_eval/int_to_{task}.json"
    elif dataset in ("pascal", "zchsound"):
        path = f"feature/{dataset}_{task}_eval/int_to_label.json"
    else:
        return None
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def expand_per_class(
    results: Dict[str, object], dataset: Optional[str], task: Optional[str]
) -> Dict[str, float]:
    """Flatten per-class metric arrays into `{metric}_{label}` scalars the way
    the reference logs them (models_eval.py log_metrics:584-600); scalar
    entries pass through unchanged."""
    mapping = get_int_to_label_mapping(dataset, task) if dataset else None
    out: Dict[str, float] = {}
    for k, v in results.items():
        arr = np.asarray(v)
        if arr.ndim == 1 and arr.size > 1:
            for i, val in enumerate(arr):
                label = (mapping or {}).get(str(i), str(i))
                out[f"{k}_{label}"] = float(val)
        elif arr.ndim == 0:
            out[k] = float(arr)
    return out
