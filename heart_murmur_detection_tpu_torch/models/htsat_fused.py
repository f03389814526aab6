"""The HTS-AT eval forward with its swin blocks routed through ops/swin.py —
counterpart of heart_murmur_detection_tpu/models/htsat_fused.py.

bn0 -> pad -> bicubic time resize -> fold to a (256, 256) image -> 4x4
patch embed + LN -> 4 swin stages (stages 0-2 as (regular, shifted) block
pairs, stage 3 as split blocks) with patch merging between them -> LN ->
token mean -> (B, 768).

mm_dtype=torch.bfloat16 is the bf16 flow of the JAX path: from the resize
on, activations are bf16 with float32 LayerNorm, softmax and GELU, and the
blocks run the CUDA kernels on a card. mm_dtype=torch.float32 is the strict
float32 path (plain versions only; the kernels take bf16). The products
outside the kernels (resize, patch embed, patch merging) are plain torch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..audio.dsp import resize_bicubic_time
from ..ops.swin import _ln, _mmf, fused_swin_block, fused_swin_pair


@torch.no_grad()
def htsat_apply_fused(
    model,
    mel: torch.Tensor,
    n_frames: Optional[torch.Tensor] = None,
    mm_dtype: torch.dtype = torch.float32,
    fast_softmax: bool = False,
    impl: str = "kernel",
) -> torch.Tensor:
    """mel (B, T, F) [+ per-clip frame counts] -> latent_output (B, 768).

    model: a models.htsat.HTSAT (its weights and config). impl="kernel"
    launches the CUDA kernels for CUDA tensors (plain versions on the CPU);
    impl="plain" runs the plain versions on any device.
    """
    cfg = model.config
    B, T, Fb = mel.shape
    dev = mel.device

    # bn0 (eval: running stats)
    bn = model.bn0
    x = (mel.to(torch.float32) - bn.running_mean) * torch.rsqrt(
        bn.running_var + bn.eps
    ) * bn.weight + bn.bias

    target_T = cfg.spec_size * cfg.freq_ratio
    if n_frames is None:
        n_frames = torch.full((B,), T, dtype=torch.int32, device=dev)
    if T < target_T:
        x = F.pad(x, (0, 0, 0, target_T - T))
    x = resize_bicubic_time(x, n_frames, target_T, compute_dtype=mm_dtype)
    # fold: blocks of spec_size frames stack along freq -> (B, 4F, spec) image
    x = x.reshape(B, cfg.freq_ratio, cfg.spec_size, Fb)
    x = x.permute(0, 1, 3, 2).reshape(B, cfg.freq_ratio * Fb, cfg.spec_size)

    # patch embed: a stride == size conv is a product over flattened patches
    pe = model.patch_embed
    p = cfg.patch_size
    Hp, Wp = x.shape[1] // p, x.shape[2] // p
    patches = x.reshape(B, Hp, p, Wp, p).permute(0, 1, 3, 2, 4).reshape(B, Hp * Wp, p * p)
    w = pe.proj.weight.reshape(pe.proj.weight.shape[0], p * p)
    y = (_mmf(patches, mm_dtype) @ _mmf(w, mm_dtype).T).to(mm_dtype) + pe.proj.bias.to(mm_dtype)
    x = _ln(y, pe.norm.weight, pe.norm.bias).to(mm_dtype)

    res = (Hp, Wp)
    stages = model.prepared(mm_dtype)
    for i_layer, stage in enumerate(stages):
        H, W = res
        dim = x.shape[-1]
        xs = x.reshape(B, H, W, dim)
        kw = dict(fast_softmax=fast_softmax, impl=impl, window=stage.window)
        depth = len(stage.blocks)
        b = 0
        while b < depth:
            pb = stage.blocks[b]
            shift = 0 if b % 2 == 0 else stage.shift
            if shift == 0 and b + 1 < depth and stage.shift:
                xs = fused_swin_pair(
                    xs, pb, stage.blocks[b + 1], stage.mask, stage.shift, **kw
                )
                b += 2
                continue
            xs = fused_swin_block(xs, pb, stage.mask if shift else None, shift, **kw)
            b += 1
        x = xs.reshape(B, H * W, dim)
        if i_layer < len(stages) - 1:
            pm = model.layers[i_layer].downsample
            xs = torch.cat(
                [xs[:, 0::2, 0::2], xs[:, 1::2, 0::2], xs[:, 0::2, 1::2], xs[:, 1::2, 1::2]],
                dim=-1,
            ).reshape(B, -1, 4 * dim)
            m = _ln(xs, pm.norm.weight, pm.norm.bias)
            x = (_mmf(m, mm_dtype) @ _mmf(pm.reduction.weight, mm_dtype).T).to(mm_dtype)
            res = (H // 2, W // 2)

    x = _ln(x, model.norm.weight, model.norm.bias)
    return x.mean(dim=1)
