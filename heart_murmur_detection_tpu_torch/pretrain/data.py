"""Host-side SSL corpus handling for continued pretraining — a copy of
heart_murmur_detection_tpu/pretrain/data.py, pinned to the original by
tests/test_torch_pretrain.py (COLA) and tests/test_torch_mae_train.py (MAE).

Replicates the reference's multi-corpus machinery:
- per-corpus spectrogram .npy file lists (heart_pressl.py manifests)
- per-corpus max_len crop sizes (cola_training.py:293-308)
- CombinedLoader('max_size_cycle') epoch semantics + per-step weighted corpus
  choice (ColaMD.training_step :314-330): epoch length = max corpus batches,
  each step draws ONE corpus with probability proportional to its batch count.
- COLA item pipeline (cola AudioDataset :56-80): full-clip markov row-mask ->
  two random crops -> independent gains.
- MAE item pipeline (mae_training AudioDataset :87-109): crop-or-zero-pad to
  (max_len, n_mels), full batches only (drop_last).

The 90/10 split is sklearn's train_test_split(random_state=1337) written in
numpy (the card's machine has no sklearn): RandomState(1337).permutation(n),
the first ceil(0.1 n) indices are the validation set, the rest train.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..audio.augment import np_random_crop, np_random_mask, np_random_multiply

OPTIMAL_MAX_LEN_COLA = {
    "covidbreath": 200,
    "covidcough": 50,
    "icbhi": 50,
    "icbhicycle": 50,
    "coughvid": 50,
    "hf_lung": 200,
    "covidUKexhalation": 100,
    "covidUKcough": 50,
    "circor": 251,
    "pascal_A": 63,
    "pascal_B": 63,
    "physionet16": 251,
    "zchsound_clean": 251,
    "zchsound_noisy": 251,
}

OPTIMAL_MAX_LEN_MAE = {
    "covidbreath": 256,
    "covidcough": 64,
    "icbhicycle": 64,
    "coughvid": 64,
    "hf_lung": 256,
    "covidUKexhalation": 128,
    "covidUKcough": 64,
}

def manifest_path(corpus: str, method: str = "cola", in_domain: bool = False) -> str:
    """Per-corpus spectrogram manifest. Heart corpora live under
    feature/<c>_eval/ (heart_pressl.py); legacy respiratory corpora keep their
    reference locations under datasets/ (cola_training.py:142-179)."""
    legacy = {
        "covidbreath": "datasets/covid19-sounds/SSL_entireaudio_filenames_breath.npy",
        "covidcough": "datasets/covid19-sounds/SSL_entireaudio_filenames_cough.npy",
        "icbhi": "datasets/icbhi/entire_spec_filenames.npy",
        "icbhicycle": "datasets/icbhi/cycle_spec_pad2_name.npy",
        "coughvid": "datasets/coughvid/entire_spec_filenames.npy",
        "hf_lung": "datasets/hf_lung/entire_spec_filenames.npy",
        "covidUKexhalation": "datasets/covidUK/entire_exhalation_filenames.npy",
        "covidUKcough": "datasets/covidUK/entire_cough_filenames.npy",
    }
    if corpus in legacy:
        return legacy[corpus]
    base = "audiomae_entire_spec" if method == "audiomae" else "entire_spec"
    if in_domain:
        base += "_in_domain"
    return f"feature/{corpus}_eval/{base}_filenames.npy"


@dataclasses.dataclass
class Corpus:
    name: str
    train: List[np.ndarray]
    val: List[np.ndarray]
    max_len: int


def split_train_val(items: Sequence, val_fraction: float = 0.1, seed: int = 1337):
    """sklearn.model_selection.train_test_split(items, test_size=val_fraction,
    random_state=seed) in numpy: (train, val) lists."""
    n = len(items)
    n_val = math.ceil(val_fraction * n)
    perm = np.random.RandomState(seed).permutation(n)
    return [items[i] for i in perm[n_val:]], [items[i] for i in perm[:n_val]]


def load_corpus(
    name: str,
    max_len: int,
    method: str = "cola",
    manifest: Optional[str] = None,
    val_fraction: float = 0.1,
    split_seed: int = 1337,
    in_domain: bool = False,
) -> Corpus:
    """Load a corpus's spectrograms into RAM; 90/10 split seeded 1337
    (train_test_split(random_state=1337), cola_training.py:196)."""
    mpath = manifest or manifest_path(name, method, in_domain)
    filenames = np.load(mpath)
    if name == "icbhi":  # exclude official test split (cola_training.py:150-155)
        tt = np.load("datasets/icbhi/entire_spec_split.npy")
        filenames = filenames[tt == "train"]
    elif name == "icbhicycle":
        tt = np.load("datasets/icbhi/cycle_spec_split.npy")
        filenames = filenames[tt == "train"]
    train_f, val_f = split_train_val(list(filenames), val_fraction, split_seed)
    load = lambda f: np.load(str(f) + ".npy").astype(np.float32)
    return Corpus(name, [load(f) for f in train_f], [load(f) for f in val_f], max_len)


def cola_views_np(
    rng: np.random.Generator, x: np.ndarray, max_len: int, augment: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    if augment:
        x = np_random_mask(rng, x)
    x1 = np_random_crop(rng, x, max_len)
    x2 = np_random_crop(rng, x, max_len)
    if augment:
        x1 = np_random_multiply(rng, x1)
        x2 = np_random_multiply(rng, x2)
    return x1.astype(np.float32), x2.astype(np.float32)


def mae_item_np(rng: np.random.Generator, x: np.ndarray, max_len: int) -> np.ndarray:
    p = max_len - x.shape[0]
    if p < 0:
        x = np_random_crop(rng, x, max_len)
    elif p > 0:
        x = np.pad(x, ((0, p), (0, 0)))
    return x.astype(np.float32)


class MultiCorpusSampler:
    """max_size_cycle + per-step weighted corpus draw."""

    def __init__(
        self,
        corpora: Sequence[Corpus],
        batch_size: int,
        method: str = "cola",
        seed: int = 42,
        drop_last: Optional[bool] = None,
    ):
        self.corpora = list(corpora)
        self.bs = batch_size
        self.method = method
        self.rng = np.random.default_rng(seed)
        # mae loaders use drop_last=True (mae_training.py:219-228), cola don't
        self.drop_last = (method != "cola") if drop_last is None else bool(drop_last)
        self.n_batches = []
        for c in self.corpora:
            n = len(c.train)
            nb = n // batch_size if self.drop_last else (n + batch_size - 1) // batch_size
            self.n_batches.append(max(nb, 1))
        tot = sum(self.n_batches)
        self.weights = [b / tot for b in self.n_batches]
        self.steps_per_epoch = max(self.n_batches)
        self._iters = [self._cycle(c) for c in self.corpora]

    def _cycle(self, corpus: Corpus):
        n = len(corpus.train)
        if self.drop_last and n < self.bs:
            # a pass would yield zero batches and the while-loop would spin
            # forever; cycle items across passes to fill one full batch
            while True:
                order = np.concatenate(
                    [self.rng.permutation(n) for _ in range(-(-self.bs // n))]
                )[: self.bs]
                yield [corpus.train[j] for j in order]
        while True:
            order = self.rng.permutation(n)
            end = (n // self.bs) * self.bs if self.drop_last else n
            for i in range(0, end, self.bs):
                yield [corpus.train[j] for j in order[i : i + self.bs]]

    def next_batch(self):
        """Returns (corpus_index, batch arrays) for one training step: (x1,
        x2) views for COLA, one (B, max_len, n_mels) batch for MAE."""
        s = int(self.rng.choice(len(self.corpora), p=self.weights))
        items = next(self._iters[s])
        c = self.corpora[s]
        if self.method == "cola":
            pairs = [cola_views_np(self.rng, x, c.max_len) for x in items]
            x1 = np.stack([p[0] for p in pairs])
            x2 = np.stack([p[1] for p in pairs])
            return s, (x1, x2)
        # mae/audiomae items are crop-or-zero-pad ONLY: the reference's
        # AudioDataset ignores self.augment for these methods
        # (mae_training.py:86-107 — no random_mask in the mae/audiomae branch)
        return s, np.stack([mae_item_np(self.rng, x, c.max_len) for x in items])

    def val_batches(self, augment: bool = True):
        """Sequential over all corpora's val sets (CombinedLoader 'sequential').

        The reference evaluates with augment=True (AudioDataset built with
        augment=True for val too, cola_training.py:201-203)."""
        for s, c in enumerate(self.corpora):
            n = len(c.val)
            end = (n // self.bs) * self.bs if self.drop_last else n
            for i in range(0, end, self.bs):
                items = c.val[i : i + self.bs]
                if not items:
                    continue
                if self.method == "cola":
                    pairs = [cola_views_np(self.rng, x, c.max_len, augment) for x in items]
                    yield s, (
                        np.stack([p[0] for p in pairs]),
                        np.stack([p[1] for p in pairs]),
                    )
                else:
                    yield s, np.stack([mae_item_np(self.rng, x, c.max_len) for x in items])
