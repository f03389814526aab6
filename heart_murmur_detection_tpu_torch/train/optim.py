"""Optimizer utilities from the reference's MAE toolbox — counterpart of
heart_murmur_detection_tpu/train/optim.py (`vit_layer_id` :23,
`layerwise_lr_decay` :35, `adamw_lrd` :66, `lars` :84 as `LARS`) in
PyTorch's idiom: parameter groups and torch.optim optimizers instead of
optax chains.

- layer-wise LR decay (mae_utils/lr_decay.py:13-76, BEiT-style): a group's
  lr is lr * layer_decay ** (num_layers - layer_id), num_layers = blocks +
  1, with cls / pos / patch-embed at layer 0, blocks.i at i + 1 and
  everything after the blocks at num_layers; 1-D parameters get no weight
  decay. torch.optim.AdamW decays p by lr_g * wd before its Adam step, which
  equals optax's scale_by_adam -> add_decayed_weights -> layer scale ->
  scale(-lr) when the layer scale sits in the group's lr (lr_g = lr *
  scale), not in the gradient.
- LARS (mae_utils/lars.py:14-61, MoCo-v3 style): for ndim > 1 parameters
  g += wd * p, then g *= trust_coefficient * |p| / |g| (1 where either norm
  is 0); the momentum buffer mu = m * mu + g; p -= lr * mu. 1-D parameters
  get plain momentum SGD.
tests/test_torch_optim.py holds both to the JAX transformations over three
steps.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn


def vit_layer_id(name: str, num_layers: int) -> int:
    """Layer id of a port MAE / ViT parameter name (lr_decay.py:64-76)."""
    top = name.split(".")[0]
    if top in ("cls_token", "pos_embed") or top.startswith("patch_embed"):
        return 0
    if top == "blocks":
        return int(name.split(".")[1]) + 1
    return num_layers


def layerwise_lr_decay(
    model: nn.Module, num_blocks: int, lr: float, layer_decay: float = 0.75,
    weight_decay: float = 0.05,
) -> List[Dict]:
    """Parameter groups of `model`'s trainable parameters, one per (layer,
    decay) pair: lr * layer_decay ** (num_layers - layer_id), weight_decay
    for ndim > 1 and 0 for 1-D parameters (lr_decay.py:24-37)."""
    num_layers = num_blocks + 1
    groups: Dict[tuple, Dict] = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        lid = vit_layer_id(name, num_layers)
        wd = weight_decay if p.ndim > 1 else 0.0
        g = groups.setdefault((lid, wd), {
            "params": [], "lr": lr * layer_decay ** (num_layers - lid), "weight_decay": wd,
            "layer_id": lid})
        g["params"].append(p)
    return list(groups.values())


def adamw_lrd(
    model: nn.Module,
    num_blocks: int,
    lr: float = 1e-3,
    layer_decay: float = 0.75,
    weight_decay: float = 0.05,
) -> torch.optim.AdamW:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8) with BEiT layer-wise lr decay; 1-D
    parameters get no weight decay (lr_decay.py:31-37)."""
    return torch.optim.AdamW(
        layerwise_lr_decay(model, num_blocks, lr, layer_decay, weight_decay),
        lr=lr, betas=(0.9, 0.999), eps=1e-8)


class LARS(torch.optim.Optimizer):
    """MoCo-v3 LARS (lars.py:14-61), the JAX `lars(lr, momentum,
    weight_decay, trust_coefficient)` over `params`; see the module doc."""

    def __init__(self, params, lr: float, momentum: float = 0.9, weight_decay: float = 0.0,
                 trust_coefficient: float = 0.001):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay,
                                      trust_coefficient=trust_coefficient))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if p.ndim > 1:
                    g = g + group["weight_decay"] * p
                    pn, gn = torch.linalg.norm(p), torch.linalg.norm(g)
                    one = torch.ones_like(pn)
                    q = torch.where(pn > 0.0, torch.where(
                        gn > 0.0, group["trust_coefficient"] * pn / gn, one), one)
                    g = g * q
                state = self.state[p]
                if "mu" not in state:
                    state["mu"] = torch.zeros_like(p)
                mu = state["mu"]
                mu.mul_(group["momentum"]).add_(g)
                p.sub_(group["lr"] * mu)
        return loss
