"""The ViT towers' eval forwards with their blocks routed through
ops/vit.py — counterpart of heart_murmur_detection_tpu/models/vit_fused.py.

  operaGT : mel (B, 256, 64) -> 4x4 patch embed + pos -> cls -> 12 ViT-S
            blocks -> token mean (no cls) -> norm -> (B, 384)
  audiomae: fbank (B, T <= 1024, 128) -> zero-pad to (1024, 128) -> 16x16
            patch embed + pos -> cls -> 12 ViT-B blocks -> token mean ->
            fc_norm -> (B, 768)
  hear    : waveform (B, <= 32000) -> mel-PCEN (B, 192, 128) -> 16x16
            patch embed -> cls + learned pos -> 24 ViT-L blocks (97 tokens
            padded to 112) -> norm of the cls token -> pooler -> (B, 512)

mm_dtype=torch.bfloat16 is the bf16 flow of the JAX path: the patch embed
takes bf16 operands with float32 accumulation, the tokens enter the blocks
as bf16, and every block is the three kernels of ops/vit.py on a card
(vit_qkv, vit_attn, vit_mlp). mm_dtype=torch.float32 is the strict float32
path (plain versions only). The token mean and the final LayerNorm are
float32. The JAX package's whole-block / split-pair choice (block_plan) is a
VMEM budget of the TPU; here every block takes the same three launches.
"""

from __future__ import annotations

import torch

from ..ops.swin import _ln, _mmf
from ..ops.vit import fused_vit_block, pad_tokens
from ..parallel.tensor import mesh_of


def _patch_embed(x: torch.Tensor, conv: torch.nn.Conv2d, mm_dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W) -> (B, L, D) float32: the stride-p VALID conv as a reshape
    and one product, bf16 operands with float32 accumulation on the bf16 path
    (the JAX `_patch_embed`). Rows and columns past the last whole patch are
    dropped, as the VALID conv drops them."""
    B, H, W = x.shape
    D, _, p, _ = conv.weight.shape
    patches = (
        x[:, : H // p * p, : W // p * p]
        .to(torch.float32)
        .reshape(B, H // p, p, W // p, p)
        .permute(0, 1, 3, 2, 4)
        .reshape(B, (H // p) * (W // p), p * p)
    )
    w = conv.weight.reshape(D, p * p)
    if mm_dtype != torch.float32:
        return _mmf(patches, mm_dtype) @ _mmf(w, mm_dtype).T + conv.bias
    return patches @ w.T + conv.bias


def _encode_blocks(h, blocks, mm_dtype, fast_softmax: bool, impl: str) -> torch.Tensor:
    """Pad tokens to a multiple of 16, run the blocks, unpad, float32."""
    h, n_real = pad_tokens(h, 16)
    act = torch.bfloat16 if mm_dtype == torch.bfloat16 else torch.float32
    h = h.to(act).contiguous()
    mode = "fast" if fast_softmax else "stable"
    for p in blocks:
        h = fused_vit_block(h, p, n_real, mode, impl)
    return h[:, :n_real].to(torch.float32)


def _encode(model, x, mm_dtype, fast_softmax, impl) -> torch.Tensor:
    h = _patch_embed(x, model.patch_embed.proj, mm_dtype)
    pos = model.pos_embed
    h = h + pos[:, 1 : h.shape[1] + 1]
    cls = (model.cls_token + pos[:, :1]).expand(h.shape[0], -1, -1)
    h = torch.cat([cls, h], dim=1)
    if mesh_of(model) is not None:  # a tensor-parallel model: models/tp_blocks.py
        from .tp_blocks import vit_block

        h, n_real = pad_tokens(h, 16)
        h = h.to(torch.bfloat16 if mm_dtype == torch.bfloat16 else torch.float32)
        for blk in model.blocks:
            h = vit_block(h, blk, n_real, mm_dtype)
        return h[:, :n_real].to(torch.float32)
    return _encode_blocks(h, model.prepared(mm_dtype), mm_dtype, fast_softmax, impl)


def _final_ln(h: torch.Tensor, norm: torch.nn.LayerNorm) -> torch.Tensor:
    return _ln(h, norm.weight, norm.bias, norm.eps)


@torch.no_grad()
def mae_forward_feature_fused(
    model,
    mel: torch.Tensor,
    mm_dtype: torch.dtype = torch.float32,
    fast_softmax: bool = False,
    impl: str = "kernel",
) -> torch.Tensor:
    """operaGT LP feature: mel (B, 256, 64) -> (B, 384); model a
    models.vit_mae.MaskedAutoencoderViT. Equals its forward_feature."""
    h = _encode(model, mel, mm_dtype, fast_softmax, impl)
    return _final_ln(h[:, 1:].mean(1), model.norm)


@torch.no_grad()
def audiomae_backbone_fused(
    model,
    fb: torch.Tensor,
    mm_dtype: torch.dtype = torch.float32,
    fast_softmax: bool = False,
    impl: str = "kernel",
) -> torch.Tensor:
    """Audio-MAE extract feature: fbank (B, T <= 1024, 128) -> (B, 768);
    model a models.vit_mae.AudioMAEClassifierBackbone. Equals its forward."""
    B, T, Fb = fb.shape
    H, W = model.config.img_size
    fb = torch.nn.functional.pad(fb.to(torch.float32), (0, W - Fb, 0, H - T))
    h = _encode(model, fb, mm_dtype, fast_softmax, impl)
    return _final_ln(h[:, 1:].mean(1), model.fc_norm)


@torch.no_grad()
def hear_forward_fused(
    model,
    audio: torch.Tensor,
    mm_dtype: torch.dtype = torch.bfloat16,
    fast_softmax: bool = False,
    impl: str = "kernel",
    from_spectrogram: bool = False,
) -> torch.Tensor:
    """HeAR's pooled embedding: waveform (B, <= 32000) (or its (B, 192, 128)
    mel-PCEN with from_spectrogram) -> (B, 512); model a models.hear
    HeAREncoder. Equals its forward(...)["pooled"]. The frontend runs in
    float32 (the JAX bf16 path runs its DFT and mel at Precision.HIGH); the
    norm before pooling is per token, so norm(h)[:, 0] = norm(h[:, 0]).
    mm_dtype=torch.float32 is the strict path and runs the plain versions."""
    from ..audio.hear_frontend import hear_preprocess

    if mm_dtype == torch.float32:
        impl = "plain"
    x = audio.to(torch.float32) if from_spectrogram else hear_preprocess(audio)
    h = _patch_embed(x, model.patch_embed.proj, mm_dtype)
    cls = model.cls_token.expand(h.shape[0], -1, -1)
    h = torch.cat([cls, h], dim=1) + model.pos_embed
    h = _encode_blocks(h, model.prepared(mm_dtype), mm_dtype, fast_softmax, impl)
    return _final_ln(h[:, 0], model.norm) @ model.pooler.weight.T + model.pooler.bias
