"""COLA wrapper around the HTS-AT encoder, eval only — counterpart of
heart_murmur_detection_tpu/models/cola.py for the operaCT tower.

Keys follow the reference checkpoint: encoder.encoder.htsat.* for the
encoder, then g (768 -> 512), layer_norm and the bilinear `linear`. For the
HTS-AT encoder dim_hidden resolves to dim_fea, so there is no `middle`.
extract_feature returns the encoder latent (dim 768) or g of it (dim 512).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

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
