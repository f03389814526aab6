"""sklearn's splitters in numpy, index for index: the JAX package's
processors and probe call `sklearn.model_selection.train_test_split`
(stratified or not) and `StratifiedKFold(shuffle=True)`, and the machine
with the card has no sklearn. Each function draws from
np.random.RandomState(seed) in the order sklearn 1.x draws
(`ShuffleSplit._iter_indices`, `StratifiedShuffleSplit._iter_indices` with
`_approximate_mode`, `StratifiedKFold._make_test_folds`), so a split here is
the split the JAX package writes. tests/test_torch_process.py pins them to
sklearn. `standard_scale` is sklearn's StandardScaler (the LOOCV probes'
openSMILE scaling), pinned to it by tests/test_torch_legacy.py.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Sequence, Tuple

import numpy as np


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng) -> np.ndarray:
    """sklearn.utils.extmath._approximate_mode: per-class draws summing to
    n_draws, ties in the remainders broken by rng."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        values = np.sort(np.unique(remainder))[::-1]
        for value in values:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _take(a, idx):
    return [a[i] for i in idx] if isinstance(a, list) else np.asarray(a)[idx]


def split_indices(n: int, test_size: float, seed: int, stratify=None) -> Tuple[np.ndarray, np.ndarray]:
    """(train, test) indices of train_test_split(..., test_size=test_size,
    random_state=seed, stratify=stratify)."""
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train <= 0:
        raise ValueError(f"test_size {test_size} leaves no training sample of {n}")
    rng = np.random.RandomState(seed)
    if stratify is None:
        perm = rng.permutation(n)
        return perm[n_test:n_test + n_train], perm[:n_test]
    y = np.asarray(stratify)
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    if class_counts.min() < 2:
        raise ValueError("The least populated class in y has only 1 member, which is too few.")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(f"train ({n_train}) and test ({n_test}) sizes must be at least the "
                         f"number of classes ({len(classes)})")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train: List[int] = []
    test: List[int] = []
    for i in range(len(classes)):
        perm = rng.permutation(class_counts[i])
        idx = class_indices[i].take(perm, mode="clip")
        train.extend(idx[: n_i[i]])
        test.extend(idx[n_i[i]: n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def train_test_split(*arrays: Sequence, test_size: float, random_state: int, stratify=None):
    """sklearn.model_selection.train_test_split for a float test_size:
    [a_train, a_test, b_train, b_test, ...] (lists stay lists)."""
    train, test = split_indices(len(arrays[0]), test_size, random_state, stratify)
    out = []
    for a in arrays:
        out += [_take(a, train), _take(a, test)]
    return out


def stratified_kfold(y, n_splits: int, seed: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """StratifiedKFold(n_splits, shuffle=True, random_state=seed).split(X, y):
    (train, test) index arrays, fold by fold."""
    rng = np.random.RandomState(seed)
    y = np.asarray(y)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)  # classes by first appearance
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    if np.all(n_splits > np.bincount(y_encoded)):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of members "
                         "in each class.")
    y_order = np.sort(y_encoded)
    allocation = np.asarray(
        [np.bincount(y_order[i::n_splits], minlength=n_classes) for i in range(n_splits)]
    )
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    indices = np.arange(len(y))
    for i in range(n_splits):
        mask = test_folds == i
        yield indices[~mask], indices[mask]


def standard_scale(x_fit: np.ndarray, *xs: np.ndarray) -> List[np.ndarray]:
    """StandardScaler().fit(x_fit) applied to x_fit and to each of xs, as
    sklearn computes it: float64 column means and population variances
    (ddof 0) by the corrected two-pass sum, a near-constant column
    (`_is_constant_feature`) scaled by 1, then x - mean and / scale in the
    input's float dtype (float32 stays float32). Returns the scaled
    arrays, x_fit's first."""
    x_fit = np.asarray(x_fit)
    dtype = x_fit.dtype if x_fit.dtype in (np.float32, np.float64) else np.float64
    x = x_fit.astype(dtype)
    n = x.shape[0]
    total = np.sum(x, axis=0, dtype=np.float64)
    mean = total / n
    temp = x - mean
    correction = np.sum(temp, axis=0, dtype=np.float64)
    var = (np.sum(temp ** 2, axis=0, dtype=np.float64) - correction ** 2 / n) / n
    eps = np.finfo(np.float64).eps
    constant = var <= n * eps * var + (n * mean * eps) ** 2
    scale = np.sqrt(var)
    scale[constant] = 1.0
    m, s = mean.astype(dtype), scale.astype(dtype)
    return [(np.asarray(a).astype(dtype) - m) / s for a in (x_fit, *xs)]
