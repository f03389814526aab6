"""COLA wrapper around the HTS-AT (OPERA-CT) or EfficientNet-B0 (OPERA-CE)
encoder — counterpart of heart_murmur_detection_tpu/models/cola.py
(`ColaConfig.resolved` :37, `Cola` :51, `extract_feature` :103).

Keys follow the reference checkpoints: encoder.encoder.htsat.* for the
HTS-AT, encoder.cnn1.* and encoder.efficientnet.* for the EfficientNet,
then [middle,] g (dim_hidden -> dim_out), layer_norm and the bilinear
`linear`. For the HTS-AT, dim_hidden resolves to dim_fea (768), so there
is no `middle`; the EfficientNet has one only when dim_hidden differs from
its 1280 features. extract_feature returns the encoder output (dim_fea),
middle of it (dim_hidden) or g of that (dim_out).
project is the projector ([middle ->] dropout -> g -> dropout ->
tanh(LN) -> dropout); forward_pair the eval pair forward; cola_loss the
bilinear InfoNCE loss. The training pair forward is
models.htsat_train_fused.cola_train_apply for the HTS-AT and
Cola.train_pair for the EfficientNet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .efficientnet import HEAD_CH, ColaEfficientNetEncoder
from .htsat import HTSAT, HTSATConfig


class Cola(nn.Module):
    def __init__(self, htsat: HTSATConfig = HTSATConfig(), dim_out: int = 512,
                 encoder: str = "htsat", dim_hidden: Optional[int] = None, p: float = 0.1):
        super().__init__()
        self.kind = encoder
        if encoder == "htsat":
            self.encoder = nn.Module()  # reference nesting: encoder.encoder.htsat
            self.encoder.encoder = nn.Module()
            self.encoder.encoder.htsat = HTSAT(htsat)
            self.dim_fea = htsat.num_features
            dim_hidden = self.dim_fea
        elif encoder == "efficientnet":
            self.encoder = ColaEfficientNetEncoder(drop_connect_rate=p)
            self.dim_fea = HEAD_CH
            dim_hidden = dim_hidden or self.dim_fea
        else:
            raise ValueError(f"encoder {encoder!r}: 'htsat' or 'efficientnet'")
        self.dim_hidden = dim_hidden
        if dim_hidden != self.dim_fea:
            self.middle = nn.Linear(self.dim_fea, dim_hidden)
        self.g = nn.Linear(dim_hidden, dim_out)
        self.layer_norm = nn.LayerNorm(dim_out, eps=1e-5)
        self.linear = nn.Linear(dim_out, dim_out, bias=False)

    @property
    def htsat(self) -> HTSAT:
        return self.encoder.encoder.htsat

    def project(
        self, h: torch.Tensor, gen: Optional[torch.Generator] = None, p: float = 0.0
    ) -> torch.Tensor:
        """[middle ->] dropout -> g -> dropout -> tanh(LayerNorm) -> dropout
        (Cola._embed after the encoder); p = 0 is the eval projector."""
        from .htsat_train_fused import _dropout

        if hasattr(self, "middle"):
            h = self.middle(h)
        h = self.g(_dropout(gen, h, p))
        return _dropout(gen, torch.tanh(self.layer_norm(_dropout(gen, h, p))), p)

    def _encode_eval(self, x, mm_dtype, impl):
        if self.kind == "htsat":
            return self.htsat(x, mm_dtype=mm_dtype, impl=impl).float()
        return self.encoder(x, dtype=None if mm_dtype == torch.float32 else mm_dtype)

    @torch.no_grad()
    def forward_pair(
        self,
        x1: torch.Tensor,
        x2: torch.Tensor,
        mm_dtype: torch.dtype = torch.float32,
        impl: str = "kernel",
    ):
        """Eval pair forward (Cola.__call__, train=False): (linear(z1), z2).
        The EfficientNet takes mm_dtype as its convolutions' dtype."""
        z1 = self.project(self._encode_eval(x1, mm_dtype, impl))
        z2 = self.project(self._encode_eval(x2, mm_dtype, impl))
        return self.linear(z1), z2

    def train_pair(self, x1: torch.Tensor, x2: torch.Tensor, gen: Optional[torch.Generator],
                   p_drop: float = 0.1, dtype: Optional[torch.dtype] = None):
        """EfficientNet train-mode pair forward (Cola.__call__, train=True):
        ((linear(z1), z2), the BatchNorms' new running statistics, chained
        through the two encoder calls in order, keyed by module). Drop-connect
        and dropout draw from gen; dtype is the convolutions' compute dtype
        (None: float32). Nothing is written into the model."""
        stats = {}
        h1 = self.encoder(x1, None, dtype, stats, gen)
        h2 = self.encoder(x2, None, dtype, stats, gen)
        z1 = self.project(h1, gen, p_drop)
        z2 = self.project(h2, gen, p_drop)
        return (self.linear(z1), z2), stats

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
        if self.kind == "htsat":
            h = self.htsat(mel, n_frames, mm_dtype, fast_softmax, impl)
        else:  # float32, as the JAX extractor runs this graph
            h = self.encoder(mel, n_frames)
        if dim == self.dim_fea:
            return h
        if hasattr(self, "middle"):
            h = self.middle(h)
        if dim == self.dim_hidden:
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
