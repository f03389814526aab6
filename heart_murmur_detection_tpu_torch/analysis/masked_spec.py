"""MAE masked-spectrogram reconstruction figures (res_analysis/
visualize_masked_spec.py) — counterpart of
heart_murmur_detection_tpu/analysis/masked_spec.py (`reconstruct` :16,
`plot_reconstruction` :37).

The encoder runs through models/mae_train_fused.py::mae_encode_train_fused
with the eval blocks (train=False): on a card in bf16 it launches the ViT
forward kernels vit_qkv, vit_attn, vit_proj and vit_mlp; the swin-v2-cr
decoder is plain torch, as it is XLA in the JAX package. mm_dtype=float32
is the strict float32 path (the plain blocks).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..models.mae_train_fused import mae_encode_train_fused
from ..models.vit_mae import MaskedAutoencoderViT, masking_noise


@torch.no_grad()
def reconstruct(model: MaskedAutoencoderViT, mel, seed: int = 0,
                noise: Optional[torch.Tensor] = None,
                mm_dtype: torch.dtype = torch.float32, impl: str = "kernel"):
    """-> (original, masked input, reconstruction, loss) of one spectrogram
    mel (T, F) (or of a batch (B, T, F), each image then (B, T, F)), on the
    model's device. model: a MaskedAutoencoderViT built with its decoder.
    The masking noise (B, L) is `noise` when given, else uniform draws from
    a torch.Generator seeded by `seed` (the JAX draw's distribution, not
    its numbers). The masked input keeps the visible patches of the raw
    patchified mel (target (1 - mask)), the reconstruction puts the
    decoder's predictions on the masked ones (pred mask + target (1 -
    mask)); the loss is the pretraining loss of that masking."""
    if not model.has_decoder:
        raise ValueError("reconstruct needs a MaskedAutoencoderViT built with decoder=True")
    dev = model.norm.weight.device
    single = np.ndim(mel) == 2
    x = torch.as_tensor(np.asarray(mel, np.float32), device=dev)
    x = x[None] if single else x
    p = model.config.patch_size
    if noise is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        noise = masking_noise(x.shape[0], (x.shape[1] // p) * (x.shape[2] // p), gen, dev)
    h, mask, ids_restore = mae_encode_train_fused(model, x, noise.to(dev), None, mm_dtype, impl,
                                                  train=False)
    pred = model.forward_decoder(h, ids_restore, mm_dtype).to(torch.float32)
    loss = model.masked_loss(x, pred, mask)
    target = model.patchify(x)
    m = mask[..., None]
    masked_img = model.unpatchify(target * (1 - m))
    recon = model.unpatchify(pred * m + target * (1 - m))
    out = [t.cpu().numpy() for t in (x, masked_img, recon)]
    if single:
        out = [a[0] for a in out]
    return (*out, float(loss))


def plot_reconstruction(mel, masked, recon, path: Optional[str] = None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for ax, img, name in zip(axes, [mel, masked, recon], ["original", "masked", "reconstruction"]):
        ax.imshow(np.asarray(img).T, aspect="auto", origin="lower")
        ax.set_title(name)
    if path:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fig.savefig(path, bbox_inches="tight", dpi=120)
        plt.close(fig)
    return fig
