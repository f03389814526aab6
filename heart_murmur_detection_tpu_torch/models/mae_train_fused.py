"""The MAE pretraining loss and the fine-tuning backbones with the encoder's
ViT blocks on the training kernels — counterpart of
heart_murmur_detection_tpu/models/mae_train_fused.py (`mae_encode_train_fused`
:36, `audiomae_backbone_train_fused` :100, `gt_backbone_train_fused` :143,
`mae_train_loss_fused` :177).

  x (B, T, F) spectrogram -> float32 patch embed (TF32 off) + positions ->
  random masking (noise (B, L), or drawn from a generator) -> cls -> pad to a
  multiple of 16 -> the encoder's blocks through
  ops.vit_train.fused_vit_block_train (ops.vit.fused_vit_block without
  gradients) -> [:, :n_real] -> final LN -> the decoder of
  models.vit_mae.MaskedAutoencoderViT in the flow's dtype -> the masked-patch
  MSE.

L, the patch count that masking draws over, comes from the batch, (T / p)
(F / p), so a corpus cropped to a shorter max_len masks its own token count
(the JAX package's data-parallel path took it from cfg.patch_hw, ADVICE.md
item 1). The masking gathers are torch.gather (the JAX package's one-hot
products were a TPU gather workaround).

mm_dtype=torch.bfloat16 is the bf16 flow of the JAX fused step (bf16 encoder
blocks, the decoder in its bf16 class, mae_decoder_opt's); float32 is the
strict float32 path. The patch embed stays float32 in both, as in the JAX
package (:58-62).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import vit
from ..ops.vit_train import fused_vit_block_train
from ..parallel.tensor import mesh_of
from . import tp_blocks
from .vit_fused import _final_ln, _patch_embed
from .vit_mae import (AudioMAEClassifierBackbone, MaskedAutoencoderViT, masking_noise,
                      random_masking)


def block_params(blk, mm_dtype: torch.dtype) -> vit.VitBlockParams:
    """One encoder block's kernel layout from its parameters, inside autograd."""
    return vit.vit_block_layout(blk.get_parameter, blk.num_heads, mm_dtype)


def _block(h: torch.Tensor, blk, n_real: int, mm_dtype: torch.dtype, impl: str,
           train: bool = True) -> torch.Tensor:
    """One encoder block: the training blocks, the eval blocks (train=False),
    or on a tensor-parallel model models/tp_blocks.vit_block."""
    if mesh_of(blk) is not None:
        return tp_blocks.vit_block(h, blk, n_real, mm_dtype)
    p = block_params(blk, mm_dtype)
    if train:
        return fused_vit_block_train(h, p, n_real, impl)
    return vit.fused_vit_block(h, p, n_real, "stable", "kernel" if impl == "kernel" else "plain")


def mae_encode_train_fused(
    model: MaskedAutoencoderViT,
    x: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    mm_dtype: torch.dtype = torch.float32,
    impl: str = "kernel",
    train: bool = True,
):
    """Masked encoder forward with the training blocks: x (B, T, F) ->
    (tokens (B, 1 + len_keep, D) after the final LN, mask (B, L),
    ids_restore (B, L)). impl as ops.vit_train.fused_vit_block_train;
    train=False runs the eval blocks of ops.vit (stable softmax), for a
    caller under torch.no_grad."""
    cfg = model.config
    act = torch.bfloat16 if mm_dtype == torch.bfloat16 else torch.float32
    h = _patch_embed(x, model.patch_embed.proj, torch.float32)
    B, L, D = h.shape
    h = h + model.pos_embed[:, 1 : L + 1]
    if noise is None:
        noise = masking_noise(B, L, generator, x.device)
    h, mask, ids_restore = random_masking(h, noise.to(torch.float32), cfg.mask_ratio)
    cls = (model.cls_token + model.pos_embed[:, :1]).expand(B, -1, -1)
    h, n_real = vit.pad_tokens(torch.cat([cls, h], 1), 16)
    h = h.to(act).contiguous()
    for blk in model.blocks:
        h = _block(h, blk, n_real, mm_dtype, impl, train)
    return _final_ln(h[:, :n_real].to(torch.float32), model.norm), mask, ids_restore


def _backbone_train(model, x: torch.Tensor, norm: torch.nn.LayerNorm, mm_dtype: torch.dtype,
                    impl: str) -> torch.Tensor:
    """Unmasked encoder with the training blocks: float32 patch embed (TF32
    off) + positions, cls, pad to a multiple of 16, the blocks, the mean of
    the real patch tokens [1:n_real] in float32, the final LN -> (B, D)."""
    act = torch.bfloat16 if mm_dtype == torch.bfloat16 else torch.float32
    h = _patch_embed(x, model.patch_embed.proj, torch.float32)
    B, L, D = h.shape
    h = h + model.pos_embed[:, 1 : L + 1]
    cls = (model.cls_token + model.pos_embed[:, :1]).expand(B, -1, -1)
    h, n_real = vit.pad_tokens(torch.cat([cls, h], 1), 16)
    h = h.to(act).contiguous()
    for blk in model.blocks:
        h = _block(h, blk, n_real, mm_dtype, impl)
    return _final_ln(h[:, 1:n_real].to(torch.float32).mean(1), norm)


def gt_backbone_train_fused(model: MaskedAutoencoderViT, x: torch.Tensor,
                            mm_dtype: torch.dtype = torch.float32,
                            impl: str = "kernel") -> torch.Tensor:
    """The operaGT fine-tuning encoder (the JAX GTBackbone -> MAE
    forward_feature) with the training blocks: mel (B, 256, 64) -> (B, 384)
    after the encoder's final LN. impl as ops.vit_train.fused_vit_block_train."""
    return _backbone_train(model, x, model.norm, mm_dtype, impl)


def audiomae_backbone_train_fused(model: AudioMAEClassifierBackbone, x: torch.Tensor,
                                  mm_dtype: torch.dtype = torch.float32,
                                  impl: str = "kernel") -> torch.Tensor:
    """The Audio-MAE fine-tuning encoder (AudioMAEClassifierBackbone) with
    the training blocks: fbank (B, T <= 1024, 128), zero-padded to the
    config's img_size first -> (B, 768) after fc_norm."""
    B, T, Fb = x.shape
    H, W = model.config.img_size
    x = torch.nn.functional.pad(x.to(torch.float32), (0, W - Fb, 0, H - T))
    return _backbone_train(model, x, model.fc_norm, mm_dtype, impl)


def mae_train_loss_fused(
    model: MaskedAutoencoderViT,
    x: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    mm_dtype: torch.dtype = torch.float32,
    impl: str = "kernel",
    train: bool = True,
) -> torch.Tensor:
    """The pretraining loss of a batch x (B, T, F): the masked-patch MSE of
    the decoder's predictions, with the encoder of mae_encode_train_fused.
    Equals model(x, noise)[0] (the strict float32 flax semantics) at
    mm_dtype float32."""
    h, mask, ids_restore = mae_encode_train_fused(model, x, noise, generator, mm_dtype, impl,
                                                  train)
    pred = model.forward_decoder(h, ids_restore, mm_dtype)
    return model.masked_loss(x, pred, mask)
