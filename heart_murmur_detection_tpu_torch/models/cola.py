"""COLA wrapper around the HTS-AT encoder — counterpart of
heart_murmur_detection_tpu/models/cola.py for the operaCT tower.

Keys follow the reference checkpoint: encoder.encoder.htsat.* for the
encoder, then g (768 -> 512), layer_norm and the bilinear `linear`. For the
HTS-AT encoder dim_hidden resolves to dim_fea, so there is no `middle`.
extract_feature returns the encoder latent (dim 768) or g of it (dim 512).
project is the projector (dropout -> g -> dropout -> tanh(LN) -> dropout);
forward_pair the eval pair forward; cola_loss the bilinear InfoNCE loss.
The training pair forward is models.htsat_train_fused.cola_train_apply.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .htsat import HTSAT, HTSATConfig


class Cola(nn.Module):
    def __init__(self, htsat: HTSATConfig = HTSATConfig(), dim_out: int = 512):
        super().__init__()
        self.encoder = nn.Module()  # reference nesting: encoder.encoder.htsat
        self.encoder.encoder = nn.Module()
        self.encoder.encoder.htsat = HTSAT(htsat)
        self.dim_fea = htsat.num_features
        self.g = nn.Linear(self.dim_fea, dim_out)
        self.layer_norm = nn.LayerNorm(dim_out, eps=1e-5)
        self.linear = nn.Linear(dim_out, dim_out, bias=False)

    @property
    def htsat(self) -> HTSAT:
        return self.encoder.encoder.htsat

    def project(
        self, h: torch.Tensor, gen: Optional[torch.Generator] = None, p: float = 0.0
    ) -> torch.Tensor:
        """dropout -> g -> dropout -> tanh(LayerNorm) -> dropout (Cola._embed
        after the encoder); p = 0 is the eval projector."""
        from .htsat_train_fused import _dropout

        h = self.g(_dropout(gen, h, p))
        return _dropout(gen, torch.tanh(self.layer_norm(_dropout(gen, h, p))), p)

    @torch.no_grad()
    def forward_pair(
        self,
        x1: torch.Tensor,
        x2: torch.Tensor,
        mm_dtype: torch.dtype = torch.float32,
        impl: str = "kernel",
    ):
        """Eval pair forward (Cola.__call__, train=False): (linear(z1), z2)."""
        z1 = self.project(self.htsat(x1, mm_dtype=mm_dtype, impl=impl).float())
        z2 = self.project(self.htsat(x2, mm_dtype=mm_dtype, impl=impl).float())
        return self.linear(z1), z2

    @torch.no_grad()
    def extract_feature(
        self,
        mel: torch.Tensor,
        dim: int,
        n_frames: Optional[torch.Tensor] = None,
        mm_dtype: torch.dtype = torch.float32,
        fast_softmax: bool = False,
        impl: str = "kernel",
    ) -> torch.Tensor:
        h = self.htsat(mel, n_frames, mm_dtype, fast_softmax, impl)
        if dim == self.dim_fea:
            return h
        if dim == self.g.out_features:
            return self.g(h)
        raise NotImplementedError(f"dim {dim} not reachable")


def cola_loss(z1: torch.Tensor, z2: torch.Tensor):
    """Cross entropy over bilinear similarities with diagonal targets
    (models_cola.py:148-163). Returns (loss, accuracy)."""
    logits = z1 @ z2.T
    labels = torch.arange(z1.shape[0], device=z1.device)
    loss = F.cross_entropy(logits, labels)
    acc = (logits.argmax(1) == labels).to(torch.float32).mean()
    return loss, acc
