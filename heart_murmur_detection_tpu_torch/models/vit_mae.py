"""The masked-autoencoder ViT family — counterpart of
heart_murmur_detection_tpu/models/vit_mae.py: OPERA-GT (ViT-S, patch 4, img
256x64) and Audio-MAE (ViT-B/16, img 1024x128), the encoders and, for MAE
pretraining, the swin-v2-cr decoder with the random masking and the
masked-patch loss.

Modules keep the reference torch key names (patch_embed.proj, cls_token,
blocks.{i}.norm1 / attn.qkv / attn.proj / norm2 / mlp.fc1 / mlp.fc2, norm,
fc_norm; decoder_embed, mask_token, decoder_blocks.{i}.attn.qkv / attn.proj
/ attn.meta_mlp.fc1 / attn.meta_mlp.fc2 / attn.tau / norm1 / norm2 / mlp.fc1
/ mlp.fc2, decoder_norm, decoder_pred), so reference checkpoints load by
name (extract/convert.py::load_mae_ckpt). The fixed 2-D sin-cos position
embeddings are built from the config (the reference's transposed patch_hw
grid) and are not weights.

`forward_feature` and the decoder at mm_dtype float32 are the strict float32
flax semantics (the tests' reference); the extraction path runs the encoder
through models/vit_fused.py and the pretraining path through
models/mae_train_fused.py, whose blocks are the kernels of ops/vit.py and
ops/vit_train.py. The decoder stays plain torch (it is XLA in the JAX
package too). With mm_dtype bfloat16 its products (decoder_embed, qkv, the
two attention products, proj, fc1, fc2, decoder_pred) take bf16 operands
with float32 accumulation, while LayerNorm, softmax, residuals and the
meta-MLP bias stay float32: the class of the JAX package's
models/mae_decoder_opt.py (the decoder its fused pretraining step runs),
whose cosine attention normalises q and k first (norm floor 1e-3 a factor)
and folds 1/tau into q before the bf16 rounding; the float32 flow divides
the scores by max(|q||k|, 1e-6) as the flax module does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.swin import _mmf
from ..ops.vit import prep_vit_block
from . import htsat


def _sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2))
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_pos_embed_flexible(dim: int, grid_size: Tuple[int, int], cls_token: bool):
    """Fixed 2-D sin-cos embedding over grid_size = (gh, gw), w first, as
    the reference (mae_utils/pos_embed.py:38-55); a zero row for cls."""
    gh = np.arange(grid_size[0], dtype=np.float64)
    gw = np.arange(grid_size[1], dtype=np.float64)
    grid = np.stack(np.meshgrid(gw, gh), axis=0)  # w first, as reference
    emb = np.concatenate(
        [_sincos_1d(dim // 2, grid[0]), _sincos_1d(dim // 2, grid[1])], axis=1
    )
    if cls_token:
        emb = np.concatenate([np.zeros((1, dim)), emb], axis=0)
    return emb.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MAEConfig:
    """The JAX MAEConfig without its TPU attention switches."""

    img_size: Tuple[int, int] = (256, 64)
    patch_size: int = 4
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    decoder_embed_dim: int = 256
    decoder_depth: int = 16  # swin decoder_mode=1 always builds 16 blocks
    decoder_num_heads: int = 16
    mlp_ratio: float = 4.0
    mask_ratio: float = 0.7
    norm_pix_loss: bool = False
    decoder_window: Tuple[int, int] = (4, 4)
    decoder_shift: Tuple[int, int] = (2, 0)

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.img_size[0] // self.patch_size, self.img_size[1] // self.patch_size)

    @property
    def num_patches(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def patch_hw(self) -> Tuple[int, int]:
        # reference convention: (W//p, H//p) — the pos-embed grid is transposed
        return (self.grid[1], self.grid[0])


def mae_vit_small_config(**kw) -> MAEConfig:
    """OPERA-GT (model_util.py:190-211)."""
    return MAEConfig(**kw)


def audiomae_base_config(**kw) -> MAEConfig:
    """Audio-MAE ViT-B (mae_training.py:282-309, extract_feature.py:130-137)."""
    base = dict(img_size=(1024, 128), patch_size=16, embed_dim=768, depth=12, num_heads=12,
                decoder_embed_dim=512, decoder_num_heads=16)
    base.update(kw)
    return MAEConfig(**base)


class Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class ViTBlock(nn.Module):
    """Pre-norm timm block (LN eps 1e-6), eval."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, eps: float = 1e-6):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        nh, hd = self.num_heads, C // self.num_heads
        qkv = self.attn.qkv(self.norm1(x)).reshape(B, N, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        a = torch.softmax((q * hd**-0.5) @ k.transpose(-1, -2), -1)
        h = (a @ v).permute(0, 2, 1, 3).reshape(B, N, C)
        x = x + self.attn.proj(h)
        h = self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x)), approximate="none"))
        return x + h


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(1, dim, patch, stride=patch)


# ---------------------------------------------------------------------------
# the swin-v2-cr decoder
# ---------------------------------------------------------------------------


def _dense(x: torch.Tensor, lin: nn.Linear, mm_dtype: torch.dtype) -> torch.Tensor:
    """Linear with operands in mm_dtype and float32 accumulation and output."""
    return _mmf(x, mm_dtype) @ _mmf(lin.weight, mm_dtype).T + lin.bias


def _rel_log(window: Tuple[int, int]) -> np.ndarray:
    """(N*N, 2) log-spaced relative coordinates of a window (JAX :160-167)."""
    wh, ww = window
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).reshape(-1, 2)
    rel = rel.astype(np.float32)
    return (np.sign(rel) * np.log1p(np.abs(rel))).astype(np.float32)


def window_partition_2d(x: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B nW, wh ww, C)."""
    B, H, W, C = x.shape
    wh, ww = window
    x = x.reshape(B, H // wh, wh, W // ww, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, wh * ww, C)


def window_reverse_2d(x: torch.Tensor, window: Tuple[int, int], H: int, W: int) -> torch.Tensor:
    """(B nW, wh ww, C) -> (B, H, W, C)."""
    wh, ww = window
    C = x.shape[-1]
    B = x.shape[0] // ((H // wh) * (W // ww))
    x = x.reshape(B, H // wh, W // ww, wh, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def shift_mask_2d(H: int, W: int, window: Tuple[int, int], shift: Tuple[int, int]) -> np.ndarray:
    """(nW, N, N) float32 mask of a shifted block: -100 between tokens of
    different regions (JAX `_shift_mask_2d` :243)."""
    wh, ww = window
    sh, sw = shift
    img = np.zeros((H, W))
    cnt = 0
    hs = [slice(0, -wh), slice(-wh, -sh), slice(-sh, None)] if sh else [slice(None)]
    ws = [slice(0, -ww), slice(-ww, -sw), slice(-sw, None)] if sw else [slice(None)]
    for a in hs:
        for b in ws:
            img[a, b] = cnt
            cnt += 1
    win = img.reshape(H // wh, wh, W // ww, ww).transpose(0, 2, 1, 3).reshape(-1, wh * ww)
    m = win[:, None, :] - win[:, :, None]
    return np.where(m != 0, -100.0, 0.0).astype(np.float32)


class MetaMlp(nn.Module):
    def __init__(self, heads: int, hidden: int = 384):
        super().__init__()
        self.fc1 = nn.Linear(2, hidden)
        self.fc2 = nn.Linear(hidden, heads)


class SwinV2CRAttention(nn.Module):
    """Scaled cosine window attention with per-head tau (clipped at 0.01)
    and the continuous log-spaced position bias of a 2 -> 384 -> heads ReLU
    meta-MLP (JAX :140)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.meta_mlp = MetaMlp(num_heads)
        self.tau = nn.Parameter(torch.ones(num_heads))

    def meta_bias(self, rel: torch.Tensor) -> torch.Tensor:
        """(heads, N, N) float32 from the window's (N*N, 2) log-spaced
        coordinates, computed once a block (JAX `_meta_bias`)."""
        h = torch.relu(rel @ self.meta_mlp.fc1.weight.T + self.meta_mlp.fc1.bias)
        bias = h @ self.meta_mlp.fc2.weight.T + self.meta_mlp.fc2.bias  # (N*N, heads)
        N = math.isqrt(rel.shape[0])
        return bias.T.reshape(self.num_heads, N, N)

    def forward(self, x, mask, rel, mm_dtype=torch.float32):
        Bw, L, C = x.shape
        nh = self.num_heads
        qkv = _dense(x, self.qkv, mm_dtype).reshape(Bw, L, 3, nh, C // nh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        tau = self.tau.clamp(min=0.01).reshape(1, nh, 1, 1)
        qn = q.norm(dim=-1, keepdim=True)
        kn = k.norm(dim=-1, keepdim=True)
        if mm_dtype == torch.float32:  # the flax module
            denom = torch.clamp(qn @ kn.transpose(-1, -2), min=1e-6)
            attn = (q @ k.transpose(-1, -2)) / denom / tau
        else:  # mae_decoder_opt: normalise first, 1/tau into q, then round
            q = q / qn.clamp(min=1e-3) / tau
            k = k / kn.clamp(min=1e-3)
            attn = _mmf(q, mm_dtype) @ _mmf(k, mm_dtype).transpose(-1, -2)
        attn = attn + self.meta_bias(rel)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(Bw // nW, nW, nh, L, L) + mask[None, :, None]).reshape(Bw, nh, L, L)
        attn = torch.softmax(attn, -1)
        out = (_mmf(attn, mm_dtype) @ _mmf(v, mm_dtype)).transpose(1, 2).reshape(Bw, L, C)
        return _dense(out, self.proj, mm_dtype)


class SwinV2CRBlock(nn.Module):
    """Post-norm swin-v2-cr block of the MAE decoder (JAX :183). The time
    grid H follows the token count for variable-length batches; the window
    shrinks to the grid and the shift drops where the grid is no larger than
    the window."""

    def __init__(self, dim, num_heads, feat_size, window, shift, mlp_ratio=4.0, eps=1e-6):
        super().__init__()
        self.feat_size, self.window, self.shift = tuple(feat_size), tuple(window), tuple(shift)
        self.attn = SwinV2CRAttention(dim, num_heads)
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self._consts = {}

    def _window_consts(self, H, W, window, shift, device):
        """The window's log-spaced coordinates and the shift mask (or None)
        on `device`, made once a geometry: a copy from host memory would
        wait for the card at every call."""
        key = (H, W, window, shift, device)
        if key not in self._consts:
            mask = None
            if shift[0] or shift[1]:
                mask = torch.from_numpy(shift_mask_2d(H, W, window, shift)).to(device)
            self._consts[key] = (torch.from_numpy(_rel_log(window)).to(device), mask)
        return self._consts[key]

    def forward(self, x: torch.Tensor, mm_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        H, W = self.feat_size
        B, L, C = x.shape
        if L != H * W:
            H = L // W
        wh, ww = min(self.window[0], H), min(self.window[1], W)
        sh = 0 if H <= self.window[0] else self.shift[0]
        sw = 0 if W <= self.window[1] else self.shift[1]
        h = x.reshape(B, H, W, C)
        if sh or sw:
            h = torch.roll(h, (-sh, -sw), (1, 2))
        rel, mask = self._window_consts(H, W, (wh, ww), (sh, sw), x.device)
        hw = self.attn(window_partition_2d(h, (wh, ww)), mask, rel, mm_dtype)
        h = window_reverse_2d(hw, (wh, ww), H, W)
        if sh or sw:
            h = torch.roll(h, (sh, sw), (1, 2))
        x = x + self.norm1(h.reshape(B, L, C))
        m = F.gelu(_dense(x, self.mlp.fc1, mm_dtype), approximate="none")
        return x + self.norm2(_dense(m, self.mlp.fc2, mm_dtype))


class PreparedBlocks(nn.Module):
    """A ViT encoder whose `blocks` (ViTBlock) `prepared` caches laid out
    for ops/vit.py, a tuple for each (matmul dtype, device); the cache is
    dropped on load_state_dict and moves."""

    def __init__(self):
        super().__init__()
        self._prepared = {}

    def prepared(self, mm_dtype: torch.dtype):
        dev = self.cls_token.device
        key = (mm_dtype, dev)
        if key not in self._prepared:
            # plain tensors, usable in and out of inference mode
            with torch.inference_mode(False), torch.no_grad():
                self._prepared[key] = tuple(
                    prep_vit_block(blk.state_dict(), blk.num_heads, mm_dtype, dev)
                    for blk in self.blocks
                )
        return self._prepared[key]

    def invalidate_prepared(self) -> None:
        self._prepared = {}

    def _apply(self, fn, *args, **kwargs):
        self.invalidate_prepared()
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self.invalidate_prepared()
        return super()._load_from_state_dict(*args, **kwargs)


class _MAEEncoder(PreparedBlocks):
    """Patch conv, cls token and the ViT blocks."""

    def __init__(self, cfg: MAEConfig):
        super().__init__()
        self.config = cfg
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        self.blocks = nn.ModuleList(
            ViTBlock(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio) for _ in range(cfg.depth)
        )
        pos = sincos_pos_embed_flexible(cfg.embed_dim, cfg.patch_hw, cls_token=True)
        self.register_buffer("pos_embed", torch.from_numpy(pos)[None], persistent=False)

    def _tokens(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W) -> cls + patch tokens (B, 1 + L, D) with positions, f32."""
        h = self.patch_embed.proj(x[:, None].to(torch.float32)).flatten(2).transpose(1, 2)
        h = h + self.pos_embed[:, 1 : h.shape[1] + 1]
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(h.shape[0], -1, -1)
        h = torch.cat([cls, h], dim=1)
        for blk in self.blocks:
            h = blk(h)
        return h


class MaskedAutoencoderViT(_MAEEncoder):
    """The MAE: the encoder with its final LayerNorm `norm` and, with
    decoder=True, the swin-v2-cr decoder of pretraining (JAX :326). The
    extraction path builds the encoder alone."""

    def __init__(self, cfg: MAEConfig = MAEConfig(), decoder: bool = False):
        super().__init__(cfg)
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=1e-6)
        self.has_decoder = decoder
        if not decoder:
            return
        Dd = cfg.decoder_embed_dim
        self.decoder_embed = nn.Linear(cfg.embed_dim, Dd)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, Dd))
        self.decoder_blocks = nn.ModuleList(
            SwinV2CRBlock(Dd, cfg.decoder_num_heads, cfg.grid, cfg.decoder_window,
                          (0, 0) if i % 2 == 0 else cfg.decoder_shift, cfg.mlp_ratio)
            for i in range(cfg.decoder_depth)
        )
        self.decoder_norm = nn.LayerNorm(Dd, eps=1e-6)
        self.decoder_pred = nn.Linear(Dd, cfg.patch_size**2)
        pos = sincos_pos_embed_flexible(Dd, cfg.patch_hw, cls_token=True)
        self.register_buffer("decoder_pos_embed", torch.from_numpy(pos)[None], persistent=False)

    def forward_feature(self, x: torch.Tensor) -> torch.Tensor:
        """LP feature: mean tokens (no cls) then the final LN
        (models_mae.py:1032-1050). x (B, 256, 64) -> (B, 384)."""
        return self.norm(self._tokens(x)[:, 1:].mean(1))

    def embed_patches(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W) -> (B, L, D) float32 patch tokens with positions, no cls."""
        h = self.patch_embed.proj(x[:, None].to(torch.float32)).flatten(2).transpose(1, 2)
        return h + self.pos_embed[:, 1 : h.shape[1] + 1]

    def forward_encoder(self, x: torch.Tensor, noise: torch.Tensor, mask_ratio: float):
        """Masked encoder (JAX :395): -> (tokens (B, 1 + len_keep, D) after
        the final LN, mask (B, L), ids_restore (B, L))."""
        h, mask, ids_restore = random_masking(self.embed_patches(x), noise, mask_ratio)
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(h.shape[0], -1, -1)
        h = torch.cat([cls, h], 1)
        for blk in self.blocks:
            h = blk(h)
        return self.norm(h), mask, ids_restore

    def forward_decoder(self, h: torch.Tensor, ids_restore: torch.Tensor,
                        mm_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """(B, 1 + len_keep, D) encoder tokens -> (B, L, p*p) predictions
        (JAX :404): embed, mask tokens unshuffled back, decoder positions,
        cls dropped, the swin blocks, LN, the pixel head."""
        h = _dense(h, self.decoder_embed, mm_dtype)
        B, L = ids_restore.shape
        mask_tokens = self.mask_token.expand(B, L + 1 - h.shape[1], -1)
        h_ = torch.cat([h[:, 1:], mask_tokens], 1)
        h_ = torch.gather(h_, 1, ids_restore[:, :, None].expand(-1, -1, h.shape[2]))
        h = torch.cat([h[:, :1], h_], 1) + self.decoder_pos_embed[:, : L + 1]
        h = h[:, 1:]  # decoder_mode != 0 drops cls (models_mae.py:1076-1078)
        for blk in self.decoder_blocks:
            h = blk(h, mm_dtype)
        return _dense(self.decoder_norm(h), self.decoder_pred, mm_dtype)

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W) -> (B, (H/p)(W/p), p*p)."""
        p = self.config.patch_size
        B, H, W = x.shape
        x = x.reshape(B, H // p, p, W // p, p).permute(0, 1, 3, 2, 4)
        return x.reshape(B, (H // p) * (W // p), p * p)

    def masked_loss(self, x: torch.Tensor, pred: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Mean squared error over the masked patches (normalised pixels with
        norm_pix_loss)."""
        target = self.patchify(x.to(torch.float32))
        if self.config.norm_pix_loss:
            mu = target.mean(-1, keepdim=True)
            var = target.var(-1, unbiased=False, keepdim=True)
            target = (target - mu) / torch.sqrt(var + 1e-6)
        loss = ((pred - target) ** 2).mean(-1)
        return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                mask_ratio: Optional[float] = None):
        """Training forward (the JAX __call__, strict float32): -> (loss,
        pred, mask). noise (B, L) sets the masking; without it, uniform
        noise is drawn from `generator`."""
        ratio = self.config.mask_ratio if mask_ratio is None else mask_ratio
        if noise is None:
            L = (x.shape[1] // self.config.patch_size) * (x.shape[2] // self.config.patch_size)
            noise = masking_noise(x.shape[0], L, generator, x.device)
        h, mask, ids_restore = self.forward_encoder(x, noise, ratio)
        pred = self.forward_decoder(h, ids_restore)
        return self.masked_loss(x, pred, mask), pred, mask


def masking_noise(B: int, L: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """(B, L) uniform [0, 1) float32 masking noise from `generator`."""
    return torch.rand(B, L, generator=generator, device=device)


def random_masking(x: torch.Tensor, noise: torch.Tensor, mask_ratio: float):
    """Keep the int(L (1 - mask_ratio)) tokens of lowest noise (JAX
    `random_masking` :382): -> (kept tokens (B, len_keep, D), mask (B, L)
    with 1 on the masked tokens, ids_restore (B, L)). Stable argsorts, as
    jnp.argsort sorts."""
    B, L, D = x.shape
    len_keep = int(L * (1 - mask_ratio))
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    x_masked = torch.gather(x, 1, ids_keep[:, :, None].expand(-1, -1, D))
    mask = torch.ones(B, L, device=x.device)
    mask[:, :len_keep] = 0
    return x_masked, torch.gather(mask, 1, ids_restore), ids_restore


class AudioMAEClassifierBackbone(_MAEEncoder):
    """Audio-MAE's extract backbone (VisionTransformer global_pool,
    models_mae.py:1173-1224): zero-pad the fbank to img_size, encode, mean
    tokens (no cls), fc_norm."""

    def __init__(self, cfg: MAEConfig = None):
        super().__init__(cfg or audiomae_base_config())
        self.fc_norm = nn.LayerNorm(self.config.embed_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, Fb = x.shape
        H, W = self.config.img_size
        x = F.pad(x, (0, W - Fb, 0, H - T))
        return self.fc_norm(self._tokens(x)[:, 1:].mean(1))


def init_weights(module: _MAEEncoder, generator: torch.Generator) -> None:
    """Seeded random init, drawn only from `generator`: the HTS-AT init for
    the matmul, conv and norm weights (lecun-normal, zero biases, unit
    norms), and normal(0.02) for the cls token and a mask token, as flax
    initialises them."""
    htsat.init_weights(module, generator)
    with torch.no_grad():
        module.cls_token.copy_(torch.empty(module.cls_token.shape).normal_(generator=generator) * 0.02)
        if getattr(module, "mask_token", None) is not None:
            module.mask_token.copy_(
                torch.empty(module.mask_token.shape).normal_(generator=generator) * 0.02)
    module.invalidate_prepared()
