"""Model factory for the operaCT kinds — counterpart of
heart_murmur_detection_tpu/extract/registry.py.

Checkpoint paths mirror the reference's `cks/` layout. Nothing is
downloaded: a missing checkpoint raises with the expected path. Random init
draws from a seeded torch.Generator.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..models.cola import Cola
from ..models.htsat import init_weights
from . import convert

ENCODER_PATH_OPERA_CT_HT_SAT = "cks/model/encoder-operaCT.ckpt"


def is_operact(pretrain: str) -> bool:
    return "operaCT" in pretrain or pretrain == "null-htsat"


def initialize_pretrained_model(
    pretrain: str,
    ckpt_path: Optional[str] = None,
    random_init: bool = False,
    seed: int = 0,
) -> Cola:
    """Build the Cola(htsat) model for an operaCT `pretrain` on the CPU and
    load its weights: random (seeded) for random_init or a null-* pretrain,
    else from ckpt_path (default: the reference's base checkpoint path).
    Other encoder families are not ported yet and raise."""
    if not is_operact(pretrain):
        raise NotImplementedError(f"pretrain {pretrain!r}: only the operaCT kinds are ported")
    model = Cola()
    if random_init or pretrain.startswith("null"):
        init_weights(model, torch.Generator().manual_seed(seed))
        return model.eval()
    if ckpt_path is None:
        if pretrain != "operaCT":
            raise NotImplementedError(
                f"pretrain {pretrain!r}: pass ckpt_path (the continued-pretraining "
                "checkpoint registry is not ported)"
            )
        ckpt_path = ENCODER_PATH_OPERA_CT_HT_SAT
    if not os.path.exists(ckpt_path):
        raise FileNotFoundError(
            f"checkpoint for '{pretrain}' not found at {ckpt_path}; place the checkpoint there"
        )
    return convert.load_torch_ckpt(ckpt_path, model).eval()
