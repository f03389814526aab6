"""Weights into the port's Cola (operaCT) — counterpart of
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
