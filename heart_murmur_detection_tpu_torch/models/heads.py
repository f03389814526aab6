"""Evaluation heads — counterpart of heart_murmur_detection_tpu/models/heads.py
(`Head` :22, `freeze_mask_fn` :38; the reference's models_eval.py:1461-1688).

"linear": one Linear(feat_dim, classes) named fc; "mlp": fc1 (feat_dim ->
feat_dim), ReLU, fc2 (feat_dim -> classes). Weights ~ N(0, 0.01) drawn from
an explicit torch.Generator, biases 0 (weights_init, models_eval.py:1834-
1840). The parameter names are the flax module's, so
extract/convert.py::from_jax_head maps a JAX head onto this one.

freeze_mask_fn replicates the reference's requires_grad switches
(models_eval.py:341-374) as the JAX predicate matches them, on flax paths
(`encoder/layers_0_blocks_1/...`, `encoder/mae/blocks_3/...`): the port's
parameter names keep the reference's torch names (`encoder.layers.0.
blocks.1...`), so each name is first mapped to the flax path that
extract/convert.py::from_jax_classifier maps onto it (flax_path), and the
JAX predicate runs on that. tests/test_torch_finetune.py pins the trainable
set to the image of the JAX predicate's trainable leaves.
"""

from __future__ import annotations

import re
from typing import Callable, Optional

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


def flax_path(name: str, encoder_kind: str) -> str:
    """The flax path of an EncoderClassifier parameter's port name: the
    inverse of extract/convert.py::from_jax_classifier's name map (leaf names
    follow torch: weight, bias)."""
    top, _, rest = name.partition(".")
    if top != "encoder":
        return "/".join([top] + rest.split("."))
    if encoder_kind == "clap2023":  # the flax HTS-AT sits directly under base
        rest = rest.replace("base.htsat.", "base.", 1)
    if encoder_kind in ("htsat", "clap2023"):
        rest = re.sub(r"layers\.(\d+)\.blocks\.(\d+)", r"layers_\1_blocks_\2", rest)
        rest = re.sub(r"layers\.(\d+)\.downsample", r"layers_\1_downsample", rest)
        prefix = ["encoder"]
    elif encoder_kind in ("efficientnet", "clap"):  # the same nesting, blocks flattened
        rest = re.sub(r"_blocks\.(\d+)", r"_blocks_\1", rest)
        prefix = ["encoder"]
    else:  # the MAE encoders and HeAR: flat flax names
        rest = re.sub(r"blocks\.(\d+)", r"blocks_\1", rest)
        for torch_name, flax_name in (("patch_embed.proj", "patch_embed_proj"),
                                      ("attn.qkv", "attn_qkv"), ("attn.proj", "attn_proj"),
                                      ("mlp.fc1", "mlp_fc1"), ("mlp.fc2", "mlp_fc2")):
            rest = rest.replace(torch_name, flax_name)
        prefix = ["encoder", "mae"] if encoder_kind == "gt" else ["encoder"]
    return "/".join(prefix + rest.split("."))


def freeze_mask_fn(freeze_encoder: str, encoder_kind: str,
                   encoder_name: str = "encoder") -> Callable[[str], bool]:
    """Predicate(port parameter name) -> trainable: the JAX freeze_mask_fn
    (none | all | early) on the name's flax path."""

    def trainable(name: str) -> bool:
        path = flax_path(name, encoder_kind)
        if encoder_name not in path:
            return True  # head always trains
        if freeze_encoder == "none":
            return True
        if freeze_encoder == "all":
            return False
        if freeze_encoder == "early":
            keep = (
                "patch_embed",
                "layers_0",
                "layers_1",
                "layers_2",
                f"{encoder_name}/norm/",  # the final LayerNorm only
                "tscam_conv",
                # efficientnet early-block names
                "cnn1",
                "_blocks_0",
                "_blocks_1",
                "_blocks_2",
                "_blocks_3",
                "_blocks_4",
            )
            return any(k in path for k in keep)
        raise ValueError(freeze_encoder)

    return trainable
