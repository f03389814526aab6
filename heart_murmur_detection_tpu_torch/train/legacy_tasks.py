"""Legacy OPERA benchmark task functions (Tasks 1–19) — a copy of
heart_murmur_detection_tpu/train/legacy_tasks.py (the reference's
linear_eval.py:105-1346), pinned to the original by
tests/test_torch_legacy.py.

Each reads the feature dir its processor (data/processors/respiratory.py)
wrote, splits as the JAX function splits (the same seeds and test sizes, on
data/splits.py's numpy copy of sklearn's train_test_split), and trains the
port's probe (train/linear_eval.py) on `device`: the classification tasks
return the test AUROC, the two LOOCV regression tasks (MMLung spirometry,
one held-out recording a fold; NoseMic respiratory rate, one held-out
subject a fold) the lists of test MAE and MAPE. The LOOCV loops keep the
corpus on the device across folds and index each fold there (openSMILE
features are standard-scaled per fold on the host first, as the reference
scales them).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..data.splits import split_indices, standard_scale, train_test_split
from .linear_eval import train_linear_head, train_regression_head


def _split_tvt(x, y, split, train_key="train"):
    tr = split == train_key
    va = split == "val"
    te = split == "test"
    return x[tr], y[tr], x[va], y[va], x[te], y[te]


def _lp(x_tr, y_tr, x_va, y_va, x_te, y_te, n_cls, **kw):
    res = train_linear_head(
        x_tr, y_tr, x_va, y_va, x_te, y_te, n_cls=n_cls, **kw
    )
    return res.test_auc


def linear_evaluation_covid19sounds(
    task=1, use_feature="opensmile", modality="cough",
    l2_strength=1e-4, lr=1e-5, head="linear", batch_size=64, epochs=64, seed=0,
    device="cuda",
):
    """Task 3/4 (linear_eval.py:105-229): downsampled dir, data_split 0/1/2."""
    folder = "feature/covid19sounds_eval/downsampled/"
    x = np.load(folder + use_feature + f"_feature_{modality}.npy").squeeze()
    y = np.load(folder + "labels.npy")
    s = np.load(folder + "data_split.npy")
    return _lp(
        x[s == 0], y[s == 0], x[s == 1], y[s == 1], x[s == 2], y[s == 2],
        n_cls=2, head=head, lr=lr, l2_strength=l2_strength,
        epochs=epochs, batch_size=batch_size, seed=seed, device=device,
    )


def linear_evaluation_icbhidisease(
    use_feature="opensmile", l2_strength=1e-4, epochs=64, batch_size=64,
    lr=1e-4, head="linear", seed=0, device="cuda",
):
    """Task 7 (linear_eval.py:232-347): Healthy-vs-COPD subset, val 20% seed 1337."""
    fd = "feature/icbhidisease_eval/"
    y_set = np.load(fd + "split.npy")
    y_label = np.load(fd + "labels.npy")
    x = np.load(fd + use_feature + "_feature.npy").squeeze()
    mask = (y_label == "Healthy") | (y_label == "COPD")
    y_label, y_set, x = y_label[mask], y_set[mask], x[mask]
    y = np.array([{"Healthy": 0, "COPD": 1}[v] for v in y_label])
    if use_feature == "vggish":
        x = np.nan_to_num(x)
    xt, yt = x[y_set == "train"], y[y_set == "train"]
    x_te, y_te = x[y_set == "test"], y[y_set == "test"]
    x_tr, x_va, y_tr, y_va = train_test_split(
        xt, yt, test_size=0.2, random_state=1337, stratify=yt
    )
    return _lp(x_tr, y_tr, x_va, y_va, x_te, y_te, n_cls=2, head=head,
               lr=lr, l2_strength=l2_strength, epochs=epochs,
               batch_size=batch_size, seed=seed, device=device)


def linear_evaluation_kauh(
    use_feature="opensmile", l2_strength=1e-6, epochs=50, lr=1e-5,
    batch_size=64, head="linear", seed=0, device="cuda",
):
    """Task 10 (linear_eval.py:350-463): healthy vs obstructive(asthma/COPD),
    val 10% seed 1337; features use the *_feature_both.npy suffix."""
    fd = "feature/kauh_eval/"
    labels = np.load(fd + "labels_both.npy")
    y_set = np.load(fd + "train_test_split.npy")
    x = np.load(fd + use_feature + "_feature_both.npy").squeeze()
    ld = {"healthy": 0, "asthma": 1, "COPD": 1, "obstructive": 1}
    y = np.array([ld[v] for v in labels])
    xt, yt = x[y_set == "train"], y[y_set == "train"]
    x_te, y_te = x[y_set == "test"], y[y_set == "test"]
    x_tr, x_va, y_tr, y_va = train_test_split(
        xt, yt, test_size=0.1, random_state=1337, stratify=yt
    )
    return _lp(x_tr, y_tr, x_va, y_va, x_te, y_te, n_cls=2, head=head,
               lr=lr, l2_strength=l2_strength, epochs=epochs,
               batch_size=batch_size, seed=seed, device=device)


def linear_evaluation_coswara(
    use_feature="operaCE1280", l2_strength=1e-6, epochs=64, lr=1e-5,
    batch_size=32, modality="breathing-deep", label="smoker", head="linear",
    seed=0, device="cuda",
):
    """Tasks 8/9 (linear_eval.py:466-593): 64/16/20 seed 1337 stratified."""
    fd = "feature/coswara_eval/"
    broad = modality.split("-")[0]
    y = np.load(fd + f"{broad}_aligned_{label}_label_{modality}.npy")
    x = np.load(fd + use_feature + f"_feature_{modality}_{label}.npy").squeeze()
    x_tr, x_te, y_tr, y_te = train_test_split(
        x, y, test_size=0.2, random_state=1337, stratify=y
    )
    x_tr, x_va, y_tr, y_va = train_test_split(
        x_tr, y_tr, test_size=0.2, random_state=1337, stratify=y_tr
    )
    if use_feature == "vggish":
        # vggish needs a balanced train set here (linear_eval.py:511-513)
        from ..utils.balance import downsample_balanced_dataset

        x_tr, y_tr = downsample_balanced_dataset(x_tr, y_tr, seed=seed)
    return _lp(x_tr, y_tr, x_va, y_va, x_te, y_te, n_cls=2, head=head,
               lr=lr, l2_strength=l2_strength, epochs=epochs,
               batch_size=batch_size, seed=seed, device=device)


def linear_evaluation_copd(
    n_cls=5, use_feature="opensmile", l2_strength=1e-5, epochs=64,
    batch_size=32, lr=1e-4, head="linear", seed=0, device="cuda",
):
    """Task 11 (linear_eval.py:596-699)."""
    fd = "feature/copd_eval/"
    y_set = np.load(fd + "train_test_split.npy")
    y = np.load(fd + "labels.npy")
    x = np.load(fd + use_feature + "_feature.npy").squeeze()
    return _lp(*_split_tvt(x, y, y_set), n_cls=n_cls, head=head, lr=lr,
               l2_strength=l2_strength, epochs=epochs,
               batch_size=batch_size, seed=seed, device=device)


def linear_evaluation_coughvid(
    use_feature="operaCE1280", l2_strength=1e-6, epochs=64, lr=1e-5,
    batch_size=64, label="sex", head="linear", seed=0, device="cuda",
):
    """Tasks 5/6 (linear_eval.py:702-807)."""
    fd = "feature/coughvid_eval/"
    y_set = np.load(fd + f"split_{label}.npy")
    y = np.load(fd + f"label_{label}.npy")
    x = np.load(fd + use_feature + f"_feature_{label}.npy").squeeze()
    if use_feature == "vggish":
        x = np.nan_to_num(x)
    return _lp(*_split_tvt(x, y, y_set), n_cls=2, head=head, lr=lr,
               l2_strength=l2_strength, epochs=epochs,
               batch_size=batch_size, seed=seed, device=device)


def linear_evaluation_coviduk(
    use_feature="operaCE1280", l2_strength=1e-6, epochs=64, lr=1e-5,
    batch_size=64, modality="exhalation", head="linear", seed=0, device="cuda",
):
    """Tasks 1/2 (linear_eval.py:810-914)."""
    fd = "feature/coviduk_eval/"
    y_set = np.load(fd + f"split_{modality}.npy")
    y = np.load(fd + f"label_{modality}.npy")
    x = np.load(fd + use_feature + f"_feature_{modality}.npy").squeeze()
    if use_feature == "vggish":
        x = np.nan_to_num(x)
    return _lp(*_split_tvt(x, y, y_set), n_cls=2, head=head, lr=lr,
               l2_strength=l2_strength, epochs=epochs,
               batch_size=batch_size, seed=seed, device=device)


def linear_evaluation_ssbpr(
    n_cls=5, use_feature="opensmile", l2_strength=1e-5, epochs=32,
    batch_size=64, lr=1e-4, head="linear", seed=None, device="cuda",
):
    """Task 12 snoring body position (linear_eval.py:917-1036): 60/20/20
    split with FIXED seed 42 regardless of run seed (reference behavior)."""
    fd = "feature/snoring_eval/"
    y = np.load(fd + "labels.npy")
    x = np.load(fd + use_feature + "_feature.npy").squeeze()
    if use_feature == "vggish":
        x = np.nan_to_num(x)
    _xt, x_te, _yt, y_te = train_test_split(
        x, y, test_size=0.2, random_state=42, stratify=y
    )
    x_tr, x_va, y_tr, y_va = train_test_split(
        _xt, _yt, test_size=0.25, random_state=42, stratify=_yt
    )
    return _lp(x_tr, y_tr, x_va, y_va, x_te, y_te, n_cls=n_cls, head=head,
               lr=lr, l2_strength=l2_strength, epochs=epochs,
               batch_size=batch_size, seed=seed or 0, device=device)


def _loocv_fold(x, x_dev, y, test, rest, opensmile: bool, val_size: float, device, **kw):
    """One LOOCV fold: the test rows out, openSMILE features standard-scaled
    on the rest, then the rest split train / val (train_test_split(
    test_size=val_size, random_state=42)) and a regression head trained."""
    tr, va = split_indices(len(rest), val_size, 42)
    if opensmile:
        x_rest, x_te = standard_scale(x[rest], x[test])
        x_tr, x_va = x_rest[tr], x_rest[va]
    else:  # the corpus stays on the device; the fold is indexed there
        sel = lambda idx: x_dev[torch.as_tensor(idx, device=x_dev.device)]
        x_tr, x_va, x_te = sel(rest[tr]), sel(rest[va]), sel(test)
    y_rest = y[rest]
    return train_regression_head(x_tr, y_rest[tr], x_va, y_rest[va], x_te, y[test],
                                 device=device, **kw)


def linear_evaluation_mmlung(
    use_feature="opensmile", method="LOOCV", l2_strength=1e-1, epochs=64,
    lr=1e-1, batch_size=40, modality="breath", label="FVC", head="mlp",
    device="cuda",
) -> Tuple[List[float], List[float]]:
    """Tasks 13-18 LOOCV regression (linear_eval.py:1039-1196): one fold a
    recording, 11% of the rest for validation, early stopping patience 5."""
    fd = "feature/mmlung_eval/"
    y_all = np.load(fd + "label.npy")
    col = {"FVC": 0, "FEV1": 1, "FEV1_FVC": 2}[label]
    y = y_all[:, col].reshape(-1, 1)
    prefix = "Deep_Breath_file_" if modality == "breath" else "O_Single_file_"
    x = np.load(fd + prefix + use_feature + "_feature.npy").squeeze()
    if use_feature == "vggish":
        x = np.nan_to_num(x)
    opensmile = "opensmile" in use_feature
    x_dev = None if opensmile else torch.as_tensor(np.asarray(x, np.float32), device=device)

    maes, mapes = [], []
    idx = np.arange(len(x))
    for s in range(len(x)):
        mae, mape = _loocv_fold(
            x, x_dev, y, idx[s:s + 1], np.delete(idx, s), opensmile, 0.11, device,
            head=head, lr=lr, l2_strength=l2_strength, epochs=epochs,
            batch_size=batch_size, patience=5,
        )
        maes.append(mae)
        mapes.append(mape)
    return maes, mapes


NOSEMIC_UIDS = ["4", "5", "6", "7", "8", "9", "10", "11", "12", "13", "14",
                "17", "18", "19", "20", "21"]


def linear_evaluation_nosemic(
    use_feature="opensmile", method="LOOCV", l2_strength=1e-1, epochs=64,
    batch_size=64, lr=1e-4, head="mlp", device="cuda",
) -> Tuple[List[float], List[float]]:
    """Task 19 respiratory-rate LOOCV by subject (linear_eval.py:1199-1346):
    one fold a subject of NOSEMIC_UIDS present in the corpus, 20% of the
    rest for validation, no early stopping."""
    fd = "feature/nosemic_eval/"
    uids = np.load(fd + "uids.npy")
    y = np.array([float(v) for v in np.load(fd + "labels.npy")]).reshape(-1, 1)
    x = np.load(fd + use_feature + "_feature.npy").squeeze()
    opensmile = "opensmile" in use_feature
    x_dev = None if opensmile else torch.as_tensor(np.asarray(x, np.float32), device=device)

    maes, mapes = [], []
    for uid in NOSEMIC_UIDS:
        test, rest = np.where(uids == uid)[0], np.where(uids != uid)[0]
        if len(test) == 0:
            continue
        mae, mape = _loocv_fold(
            x, x_dev, y, test, rest, opensmile, 0.2, device,
            head=head, lr=lr, l2_strength=l2_strength, epochs=epochs,
            batch_size=batch_size,
        )
        maes.append(mae)
        mapes.append(mape)
    return maes, mapes
