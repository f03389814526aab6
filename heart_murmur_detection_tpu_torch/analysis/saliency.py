"""Gradient saliency maps of a frozen encoder and a linear head
(res_analysis/saliency_map.py:132-159) — counterpart of
heart_murmur_detection_tpu/analysis/saliency.py (`compute_saliency_map`
:14, `saliency_for_linear_head` :35, `plot_saliency` :48) on torch autograd.

The saliency of a clip is |d logit_c / d mel| for the given or the argmax
class c. The JAX package vmaps one grad a clip; an eval-mode encoder keeps
its rows independent, so here one backward of sum_i logit[i, c_i] gives
every clip's map at once.

operact_encoder is the operaCT encoder for it on the card: the HTS-AT
training forward (models/htsat_train_fused.py::htsat_encode_train) with bn0
on its running statistics and DropPath off, stages 0-2 through K8's
ops/swin_train.py::fused_swin_block_train (bf16: the input gradient from
the swin_mlp_bwd / swin_attn_bwd kernels), stage 3 in float32. The weights
take no gradient, so the backward launches no weight product.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch

from ..models.htsat_train_fused import htsat_encode_train


def compute_saliency_map(apply_fn: Callable[[torch.Tensor], torch.Tensor], mel,
                         target_class: Optional[int] = None):
    """apply_fn: mel (B, T, F) -> logits (B, C), rows independent. Returns
    (|d logit_c / d mel| (B, T, F), the classes (B,)) as numpy, c the
    target class or each clip's argmax. mel: an array, or a tensor on the
    device apply_fn runs on."""
    x = torch.as_tensor(mel, dtype=torch.float32).detach().clone().requires_grad_(True)
    with torch.enable_grad():
        logits = apply_fn(x)
        if target_class is not None:
            classes = torch.full((x.shape[0],), int(target_class), device=logits.device)
        else:
            classes = logits.detach().argmax(dim=-1)
        picked = logits.gather(1, classes[:, None].to(torch.int64)).sum()
        (g,) = torch.autograd.grad(picked, x)
    return g.abs().cpu().numpy(), classes.cpu().numpy()


def saliency_for_linear_head(encoder_apply: Callable[[torch.Tensor], torch.Tensor], head, mel,
                             target_class: Optional[int] = None):
    """Frozen encoder feature -> the head (a models/heads.py::Head) ->
    logits -> saliency with respect to mel."""
    return compute_saliency_map(lambda x: head(encoder_apply(x)), mel, target_class)


@contextlib.contextmanager
def _frozen(module: torch.nn.Module):
    """The module's parameters take no gradient inside the block."""
    flags = [(p, p.requires_grad) for p in module.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in flags:
            p.requires_grad_(f)


def operact_encoder(model, mm_dtype: torch.dtype = torch.bfloat16,
                    impl: str = "kernel") -> Callable[[torch.Tensor], torch.Tensor]:
    """The operaCT latent (B, 768) of a mel batch as a differentiable
    function of the mel (see the module doc). model: a models.cola.Cola or
    its HTS-AT. mm_dtype bf16 with impl "kernel" is K8's route, impl
    "plain" the plain bf16 flow; float32 the strict float32 path."""
    enc = getattr(model, "htsat", model)

    def apply(mel: torch.Tensor) -> torch.Tensor:
        with _frozen(enc):
            return htsat_encode_train(enc, mel, None, None, mm_dtype=mm_dtype,
                                      deterministic=True, impl=impl)[0]

    return apply


def plot_saliency(mel: np.ndarray, sal: np.ndarray, title: str = "", path: Optional[str] = None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
    axes[0].imshow(mel.T, aspect="auto", origin="lower")
    axes[0].set_ylabel("mel bin")
    axes[0].set_title(f"input {title}")
    axes[1].imshow(sal.T, aspect="auto", origin="lower", cmap="hot")
    axes[1].set_ylabel("mel bin")
    axes[1].set_xlabel("frame")
    axes[1].set_title("|saliency|")
    if path:
        fig.savefig(path, bbox_inches="tight", dpi=120)
        plt.close(fig)
    return fig
