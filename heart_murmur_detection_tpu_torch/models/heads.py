"""Evaluation heads — counterpart of heart_murmur_detection_tpu/models/heads.py
(`Head` :22; the reference's models_eval.py:1461-1688).

"linear": one Linear(feat_dim, classes) named fc; "mlp": fc1 (feat_dim ->
feat_dim), ReLU, fc2 (feat_dim -> classes). Weights ~ N(0, 0.01) drawn from
an explicit torch.Generator, biases 0 (weights_init, models_eval.py:1834-
1840). The parameter names are the flax module's, so
extract/convert.py::from_jax_head maps a JAX head onto this one.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class Head(nn.Module):
    def __init__(self, classes: int, head: str = "linear", feat_dim: int = 768,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if head == "linear":
            self.fc = nn.Linear(feat_dim, classes)
        elif head == "mlp":
            self.fc1 = nn.Linear(feat_dim, feat_dim)
            self.fc2 = nn.Linear(feat_dim, classes)
        else:
            raise NotImplementedError(head)
        self.head = head
        with torch.no_grad():
            for layer in self.children():
                layer.weight.copy_(torch.randn(layer.weight.shape, generator=generator) * 0.01)
                layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.head == "linear":
            return self.fc(x)
        return self.fc2(torch.relu(self.fc1(x)))
