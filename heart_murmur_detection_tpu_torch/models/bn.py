"""flax BatchNorm semantics for the port's convolutional towers (the
EfficientNet-B0 of OPERA-CE, CLAP-2022's Cnn14).

Eval mode normalises with the running statistics. Train mode follows
flax.linen.BatchNorm: the batch mean and the biased batch variance over
every axis but the channel axis (1), computed in float32 whatever the input
dtype (the float32 island of the JAX package's mixed-precision towers), and
the running statistics become momentum * old + (1 - momentum) * batch with
that biased variance, which torch's BatchNorm2d train mode does not give
(it updates with the unbiased one, which the port rescales). flax forms
the variance as max(0, mean(x^2) - mean(x)^2), which loses digits in
float32 when a channel's mean is large against its spread (the Cnn14's bn0
over dB log-mels); torch's fused BatchNorm centres it, so the port stays
nearer the exact value than flax does.

Train mode writes the new running statistics into `stats` (a dict keyed
by the BatchNorm2d module) instead of the module: a second call through
the same module reads the first call's statistics from the dict, as two
flax applies chain their mutable batch_stats, and nothing changes in the
model until the caller commits the dict after its optimizer step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Stats = Dict[nn.BatchNorm2d, Tuple[torch.Tensor, torch.Tensor]]


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor, momentum: float,
               stats: Optional[Stats] = None) -> torch.Tensor:
    """x (B, C, ...) -> output in the parameters' dtype. stats None: eval (the running
    statistics); a dict: train mode, the new running statistics into it."""
    x = x.to(bn.weight.dtype)  # float32 (or a float64 model's float64)
    if stats is None:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                            bn.eps)
    n = x.numel() // x.shape[1]
    old_mean, old_var = stats.get(bn, (bn.running_mean, bn.running_var))
    mean, var = old_mean.clone(), old_var.clone()
    # torch's fused train-mode BatchNorm: the batch statistics (a centred
    # variance), and the running update old * momentum + batch * (1 -
    # momentum) into the clones, with the unbiased variance, which is
    # rescaled to flax's biased one: (n - 1) / n of the batch's share
    y = F.batch_norm(x, mean, var, bn.weight, bn.bias, True, 1.0 - momentum, bn.eps)
    stats[bn] = (mean, momentum * old_var + (var - momentum * old_var) * ((n - 1) / n))
    return y


@torch.no_grad()
def commit(stats: Stats) -> None:
    """Write a train step's running statistics into their modules."""
    for bn, (mean, var) in stats.items():
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)
