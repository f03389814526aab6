"""t-SNE embedding visualisation (res_analysis/visualize_embedding.py,
src/util.py:648-708) — a copy of
heart_murmur_detection_tpu/analysis/embeddings.py on the port's
audio/reference_np.py. sklearn and matplotlib are imported inside the
functions: the card's machine has neither."""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np


def tsne_embed(x: np.ndarray, perplexity: int = 40, n_iter: int = 300, seed: int = 42):
    from sklearn.manifold import TSNE

    tsne = TSNE(
        n_components=2,
        perplexity=min(perplexity, max(2, len(x) // 4)),
        max_iter=max(n_iter, 250),
        random_state=seed,
        init="pca",
    )
    return tsne.fit_transform(np.asarray(x, np.float64))


def plot_tsne(
    x: np.ndarray,
    labels: Sequence,
    title: str = "",
    out_dir: str = "fig/tsne",
    order: Optional[Sequence] = None,
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = tsne_embed(x)
    os.makedirs(out_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(8, 6))
    labels = np.asarray(labels)
    uniq = order if order is not None else sorted(set(labels.tolist()))
    for u in uniq:
        m = labels == u
        ax.scatter(pts[m, 0], pts[m, 1], s=18, alpha=0.7, label=str(u))
    ax.legend()
    ax.set_title(title or "t-SNE")
    name = title or str(time.time())
    path = os.path.join(out_dir, f"{name}.png")
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    print("t-sne plot saved to", path)
    return pts, path


def plot_melspectrogram(
    audio: np.ndarray,
    title: str = "",
    sample_rate: int = 16000,
    n_mels: int = 64,
    f_min: float = 50,
    f_max: float = 2000,
    nfft: int = 1024,
    hop: int = 512,
    out_dir: str = "fig/spectrogram",
):
    """Mel-spectrogram figure (src/util.py:711-741) rendered from our numpy
    librosa-parity frontend instead of librosa itself."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..audio.reference_np import mel_filterbank_slaney, stft_power

    S = mel_filterbank_slaney(sample_rate, nfft, n_mels, f_min, f_max) @ stft_power(
        np.asarray(audio, np.float32), nfft, hop
    )
    s_db = 10.0 * np.log10(np.maximum(S, 1e-10) / max(S.max(), 1e-10))
    s_db = np.maximum(s_db, s_db.max() - 80.0)

    os.makedirs(out_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(10, 4))
    extent = [0, S.shape[1] * hop / sample_rate, f_min, f_max]
    img = ax.imshow(s_db, origin="lower", aspect="auto", extent=extent)
    fig.colorbar(img, ax=ax, format="%+2.0f dB")
    name = title or str(time.time())
    ax.set(title="Mel-frequency spectrogram " + name, xlabel="time", ylabel="Hz")
    path = os.path.join(out_dir, f"{name}.png")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path
