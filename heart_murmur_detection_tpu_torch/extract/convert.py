"""Weights into the port's models — counterpart of
heart_murmur_detection_tpu/extract/convert.py.

- `from_jax(variables)`: the JAX package's flax `Cola` variables
  ({"params", "batch_stats"}, numpy arrays) -> the port's state_dict; the
  inverse of the JAX `convert_cola_htsat`. A gradient tree ({"params"} only,
  no batch_stats) maps the same way, without the running statistics, so
  gradients compare leaf by leaf. flax Dense kernel (in, out) ->
  Linear weight (out, in); Conv kernel (kh, kw, in, out) -> (out, in, kh, kw);
  LayerNorm/BatchNorm scale -> weight; BatchNorm mean/var -> running_mean/var.
  The tscam head is not carried.
- `load_torch_ckpt(path, model)`: a reference OPERA-CT `.ckpt` into the
  port's Cola, keys matched by name (the port keeps the reference names).
- `from_jax_mae(variables, decoder=False)`: the JAX package's flax
  MaskedAutoencoderViT or AudioMAEClassifierBackbone variables -> the port's
  state_dict (models/vit_mae.py) of the encoder, or with decoder=True of the
  whole MAE tree (for a model built with its decoder); the inverse of the
  JAX `convert_mae` and `convert_audiomae_backbone`. A gradient tree maps
  the same way.
- `from_jax_head(params)`: a flax probe head's params ({"fc": {"kernel",
  "bias"}} or {"fc1": ..., "fc2": ...}, numpy) -> the port's Head
  state_dict, kernels transposed.
- `load_mae_ckpt(path, model)`: a reference OPERA-GT or Audio-MAE
  checkpoint into the port's model by key name: every key the model holds
  must be there (the decoder's too, for a model built with its decoder, as a
  warm start of MAE pretraining loads strictly); keys it does not hold
  (pos_embed, decoder_pos_embed, a decoder the model lacks) are ignored; a
  missing Audio-MAE fc_norm falls back to the encoder's norm, else to ones
  and zeros (as the JAX converter does).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

HTSAT_PREFIX = "encoder.encoder.htsat."


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(sd, key, p, bias=True):
    sd[key + ".weight"] = _t(np.asarray(p["kernel"]).T)
    if bias:
        sd[key + ".bias"] = _t(p["bias"])


def _norm(sd, key, p):
    sd[key + ".weight"] = _t(p["scale"])
    sd[key + ".bias"] = _t(p["bias"])


def from_jax(variables: dict) -> Dict[str, torch.Tensor]:
    """flax Cola(htsat) variables -> state_dict of models.cola.Cola."""
    params = variables["params"]
    enc = params["encoder"]
    sd: Dict[str, torch.Tensor] = {}
    p = HTSAT_PREFIX
    _norm(sd, p + "bn0", enc["bn0"])
    if "batch_stats" in variables:
        stats = variables["batch_stats"]["encoder"]
        sd[p + "bn0.running_mean"] = _t(stats["bn0"]["mean"])
        sd[p + "bn0.running_var"] = _t(stats["bn0"]["var"])
        sd[p + "bn0.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    k = np.asarray(enc["patch_embed"]["proj"]["kernel"])
    sd[p + "patch_embed.proj.weight"] = _t(k.transpose(3, 2, 0, 1))
    sd[p + "patch_embed.proj.bias"] = _t(enc["patch_embed"]["proj"]["bias"])
    _norm(sd, p + "patch_embed.norm", enc["patch_embed"]["norm"])
    for name in sorted(enc):
        m = re.fullmatch(r"layers_(\d+)_blocks_(\d+)", name)
        if m:
            blk, tp = enc[name], f"{p}layers.{m[1]}.blocks.{m[2]}."
            _norm(sd, tp + "norm1", blk["norm1"])
            sd[tp + "attn.relative_position_bias_table"] = _t(
                blk["attn"]["relative_position_bias_table"]
            )
            _linear(sd, tp + "attn.qkv", blk["attn"]["qkv"])
            _linear(sd, tp + "attn.proj", blk["attn"]["proj"])
            _norm(sd, tp + "norm2", blk["norm2"])
            _linear(sd, tp + "mlp.fc1", blk["mlp"]["fc1"])
            _linear(sd, tp + "mlp.fc2", blk["mlp"]["fc2"])
        m = re.fullmatch(r"layers_(\d+)_downsample", name)
        if m:
            tp = f"{p}layers.{m[1]}.downsample."
            _norm(sd, tp + "norm", enc[name]["norm"])
            _linear(sd, tp + "reduction", enc[name]["reduction"], bias=False)
    _norm(sd, p + "norm", enc["norm"])
    if "g" in params:
        _linear(sd, "g", params["g"])
        _norm(sd, "layer_norm", params["layer_norm"])
        _linear(sd, "linear", params["linear"], bias=False)
    return sd


def from_jax_mae(variables: dict, decoder: bool = False) -> Dict[str, torch.Tensor]:
    """flax MAE / Audio-MAE variables -> state_dict of
    models.vit_mae.MaskedAutoencoderViT / AudioMAEClassifierBackbone; with
    decoder=True the decoder leaves too (MaskedAutoencoderViT(cfg,
    decoder=True))."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    k = np.asarray(params["patch_embed_proj"]["kernel"])  # (kh, kw, 1, D)
    sd["patch_embed.proj.weight"] = _t(k.transpose(3, 2, 0, 1))
    sd["patch_embed.proj.bias"] = _t(params["patch_embed_proj"]["bias"])
    sd["cls_token"] = _t(params["cls_token"])
    blocks = sorted(
        (int(m[1]), name) for name in params if (m := re.fullmatch(r"blocks_(\d+)", name))
    )
    for i, name in blocks:
        blk, tp = params[name], f"blocks.{i}."
        _norm(sd, tp + "norm1", blk["norm1"])
        _linear(sd, tp + "attn.qkv", blk["attn_qkv"])
        _linear(sd, tp + "attn.proj", blk["attn_proj"])
        _norm(sd, tp + "norm2", blk["norm2"])
        _linear(sd, tp + "mlp.fc1", blk["mlp_fc1"])
        _linear(sd, tp + "mlp.fc2", blk["mlp_fc2"])
    for norm in ("norm", "fc_norm"):
        if norm in params:
            _norm(sd, norm, params[norm])
    if decoder:
        _linear(sd, "decoder_embed", params["decoder_embed"])
        sd["mask_token"] = _t(params["mask_token"])
        blocks = sorted(
            (int(m[1]), name) for name in params
            if (m := re.fullmatch(r"decoder_blocks_(\d+)", name))
        )
        for i, name in blocks:
            blk, tp = params[name], f"decoder_blocks.{i}."
            _linear(sd, tp + "attn.qkv", blk["attn"]["qkv"])
            _linear(sd, tp + "attn.proj", blk["attn"]["proj"])
            _linear(sd, tp + "attn.meta_mlp.fc1", blk["attn"]["meta_fc1"])
            _linear(sd, tp + "attn.meta_mlp.fc2", blk["attn"]["meta_fc2"])
            sd[tp + "attn.tau"] = _t(blk["attn"]["tau"])
            _norm(sd, tp + "norm1", blk["norm1"])
            _norm(sd, tp + "norm2", blk["norm2"])
            _linear(sd, tp + "mlp.fc1", blk["mlp_fc1"])
            _linear(sd, tp + "mlp.fc2", blk["mlp_fc2"])
        _norm(sd, "decoder_norm", params["decoder_norm"])
        _linear(sd, "decoder_pred", params["decoder_pred"])
    return sd


def load_mae_ckpt(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference MAE-family checkpoint (Lightning `.ckpt`, a `.pth`
    holding {"model": ...}, or a bare state_dict) into the port's model by
    key name. The model may sit under any prefix (found from its patch
    embed); keys the model does not hold are ignored; a missing key raises,
    so a model built with its decoder loads the decoder strictly."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt.get("model", ckpt))
    anchor = "patch_embed.proj.weight"
    prefix = next((k[: -len(anchor)] for k in sd if k.endswith(anchor)), None)
    if prefix is None:
        raise KeyError(f"no MAE encoder (patch_embed.proj.weight) in checkpoint {path}")
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    own = model.state_dict()
    for leaf, fill in (("weight", torch.ones), ("bias", torch.zeros)):
        key = f"fc_norm.{leaf}"
        if key in own and key not in sd:
            sd[key] = sd.get(f"norm.{leaf}", fill(own[key].shape))
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"checkpoint {path} lacks {len(missing)} keys, e.g. {missing[:3]}")
    model.load_state_dict({k: sd[k] for k in own})
    return model


def load_torch_ckpt(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference Cola(htsat) checkpoint (Lightning `.ckpt` or a bare
    state_dict) into the port's Cola. The htsat subtree may sit under
    encoder.encoder.htsat., encoder.htsat. or htsat.; keys the port does not
    carry (tscam_conv, head, ...) are ignored; a missing key raises."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt.get("model", ckpt))
    enc_prefix = next(
        (c for c in (HTSAT_PREFIX, "encoder.htsat.", "htsat.") if any(k.startswith(c) for k in sd)),
        None,
    )
    if enc_prefix is None:
        raise KeyError(f"no htsat subtree in checkpoint {path}")
    renamed = {}
    for k, v in sd.items():
        if k.startswith(enc_prefix):
            renamed[HTSAT_PREFIX + k[len(enc_prefix):]] = v
        elif not k.startswith(("encoder.", "htsat.")):
            renamed[k] = v
    own = model.state_dict()
    missing = [k for k in own if k not in renamed]
    if missing:
        raise KeyError(f"checkpoint {path} lacks {len(missing)} keys, e.g. {missing[:3]}")
    model.load_state_dict({k: renamed[k] for k in own})
    return model


def from_jax_head(params: dict) -> Dict[str, torch.Tensor]:
    """A flax models/heads.py::Head's params -> models/heads.py::Head's
    state_dict: each Dense (kernel (in, out), bias) -> Linear (weight (out,
    in), bias) under the same name (fc, or fc1 and fc2)."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
        sd[f"{name}.bias"] = _t(p["bias"])
    return sd
