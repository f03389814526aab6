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
- `from_jax_classifier(variables, encoder_kind)`: a JAX fine-tuning
  `EncoderClassifier`'s variables (params, and batch_stats where the
  encoder has BatchNorms) -> the port's train/finetune.py::EncoderClassifier
  state_dict ("encoder.*", "head.*"): htsat through from_jax, gt
  (params["encoder"]["mae"]) and audiomae through from_jax_mae,
  efficientnet through from_jax_efficientnet, clap / clap2023 through
  from_jax_clap (and the 2023 HTS-AT's tscam_conv, which the classifier
  carries unread), hear through from_jax_hear, the head through
  from_jax_head. A gradient tree maps the same way.
- `from_jax_hear(variables)`: the JAX package's flax HeAREncoder variables
  -> the port's models/hear.py::HeAREncoder state_dict (the MAE encoder's
  mapping, plus the learned pos_embed and the pooler Dense).
- `load_hear_ckpt(path_or_state_dict, model)`: a Hugging Face ViTModel
  state_dict (google/hear-pytorch's key names, optionally under a prefix
  such as "vit.") into the port's HeAREncoder, q, k and v fused into
  attn.qkv in that order, as the JAX `convert_hear_vit` fuses them.
- `from_jax_clap(variables, version)`: the JAX package's flax
  CLAPAudioEncoder variables -> the port's models/clap.py::CLAPAudioEncoder
  state_dict (msclap's names: base.htsat.* through from_jax for 2023, the
  Cnn14's base.bn0 / conv_block{i}.conv{j} / bn{j} / fc1 / fc_audioset for
  2022, projection.*); the inverse of the JAX `convert_clap_audio`. The
  HTS-AT's tscam head is not carried.
- `load_clap_ckpt(path_or_state_dict, version)`: an msclap state_dict (a
  file or the dict itself) whose audio tower sits under
  `clap.audio_encoder.`, `audio_encoder.` or `model.audio_encoder.` into
  the port's CLAPAudioEncoder by name.
- `from_jax_efficientnet(variables)`: the JAX package's flax
  Cola(efficientnet) variables -> the port's Cola(encoder="efficientnet")
  state_dict (efficientnet-pytorch's names under encoder.cnn1 /
  encoder.efficientnet, then [middle,] g, layer_norm, linear); the inverse
  of the JAX `convert_cola_efficientnet`. A depthwise kernel (kh, kw, 1, C)
  becomes (C, 1, kh, kw) as any other; the BatchNorms' flax
  `_bn*/BatchNorm_0` scale / bias / mean / var become weight / bias /
  running_mean / running_var. A gradient tree maps the same way.
- `load_cola_efficientnet_ckpt(path_or_state_dict, model)`: a reference
  OPERA-CE Cola(efficientnet) checkpoint into the port's Cola by name.
- `from_jax_vggish(variables)`: the JAX package's flax VGGish variables ->
  the port's models/vggish.py::VGGish state_dict (the same layer names; the
  port flattens fc1_1's input in the flax NHWC order, so no row permutes).
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
from typing import Dict, Mapping, Optional, Union

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


def from_jax_hear(variables: dict) -> Dict[str, torch.Tensor]:
    """flax HeAREncoder variables -> state_dict of models.hear.HeAREncoder."""
    params = variables["params"]
    sd = from_jax_mae({"params": params})
    sd["pos_embed"] = _t(params["pos_embed"])
    _linear(sd, "pooler", params["pooler"])
    return sd


# HF ViTModel layer names -> the port's block names (beside q / k / v)
_HF_BLOCK = {"layernorm_before": "norm1", "attention.output.dense": "attn.proj",
             "layernorm_after": "norm2", "intermediate.dense": "mlp.fc1",
             "output.dense": "mlp.fc2"}


def load_hear_ckpt(path_or_state_dict: Union[str, Mapping], model: torch.nn.Module
                   ) -> torch.nn.Module:
    """Load a Hugging Face ViTModel state_dict (google/hear-pytorch: a file
    torch.load reads, or the dict itself; keys may sit under a prefix, found
    from the cls token) into the port's HeAREncoder. q, k and v of each
    layer are stacked into attn.qkv in that order; the pooler comes from
    pooler.dense. Every key the model holds must be there."""
    sd = path_or_state_dict
    if isinstance(sd, str):
        sd = torch.load(sd, map_location="cpu", weights_only=False)
        sd = sd.get("state_dict", sd)
    anchor = "embeddings.cls_token"
    prefix = next((k[: -len(anchor)] for k in sd if k.endswith(anchor)), None)
    if prefix is None:
        raise KeyError("no HF ViT embeddings (embeddings.cls_token) in the HeAR state_dict")
    f32 = lambda v: (v.detach().to(torch.float32) if isinstance(v, torch.Tensor)
                     else torch.from_numpy(np.array(v, np.float32)))
    hf = {k[len(prefix):]: f32(v) for k, v in sd.items() if k.startswith(prefix)}
    out = {"cls_token": hf.get("embeddings.cls_token"),
           "pos_embed": hf.get("embeddings.position_embeddings")}
    for leaf in ("weight", "bias"):
        out[f"patch_embed.proj.{leaf}"] = hf.get(f"embeddings.patch_embeddings.projection.{leaf}")
        out[f"norm.{leaf}"] = hf.get(f"layernorm.{leaf}")
        out[f"pooler.{leaf}"] = hf.get(f"pooler.dense.{leaf}")
    for i in range(len(model.blocks)):
        tp, bp = f"encoder.layer.{i}.", f"blocks.{i}."
        for leaf in ("weight", "bias"):
            qkv = [hf.get(f"{tp}attention.attention.{n}.{leaf}") for n in ("query", "key", "value")]
            out[f"{bp}attn.qkv.{leaf}"] = None if None in qkv else torch.cat(qkv, 0)
            for theirs, ours in _HF_BLOCK.items():
                out[f"{bp}{ours}.{leaf}"] = hf.get(f"{tp}{theirs}.{leaf}")
    own = model.state_dict()
    missing = [k for k in own if out.get(k) is None]
    if missing:
        raise KeyError(f"the HeAR state_dict lacks {len(missing)} keys, e.g. {missing[:3]}")
    model.load_state_dict({k: out[k] for k in own})
    return model


def _bn_stats(sd, key, p, stats):
    """A BatchNorm's params and, unless stats is None (a gradient tree),
    its running statistics."""
    _norm(sd, key, p)
    if stats is None:
        return
    sd[key + ".running_mean"] = _t(stats["mean"])
    sd[key + ".running_var"] = _t(stats["var"])
    sd[key + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _conv_w(sd, key, p):
    """flax Conv kernel (kh, kw, in / groups, out) -> (out, in / groups,
    kh, kw), and its bias if it has one."""
    sd[key + ".weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[key + ".bias"] = _t(p["bias"])


def from_jax_clap(variables: dict, version: str = "2023") -> Dict[str, torch.Tensor]:
    """flax CLAPAudioEncoder variables -> state_dict of
    models.clap.CLAPAudioEncoder(CLAPConfig(version))."""
    params = variables["params"]
    base = params["base"]
    bstats = variables["batch_stats"]["base"] if "batch_stats" in variables else None
    if version == "2023":
        inner = {"params": {"encoder": base}}
        if bstats is not None:
            inner["batch_stats"] = {"encoder": bstats}
        sd = {"base.htsat." + k[len(HTSAT_PREFIX):]: v for k, v in from_jax(inner).items()}
    else:
        sd = {}
        _bn_stats(sd, "base.bn0", base["bn0"], bstats and bstats["bn0"])
        for name in sorted(base):
            if not name.startswith("conv_block"):
                continue
            for j in (1, 2):
                _conv_w(sd, f"base.{name}.conv{j}", base[name][f"conv{j}"])
                _bn_stats(sd, f"base.{name}.bn{j}", base[name][f"bn{j}"],
                          bstats and bstats[name][f"bn{j}"])
        _linear(sd, "base.fc1", base["fc1"])
        _linear(sd, "base.fc_audioset", base["fc_audioset"])
    proj = params["projection"]
    _linear(sd, "projection.linear1", proj["linear1"], bias=False)
    _linear(sd, "projection.linear2", proj["linear2"], bias=False)
    _norm(sd, "projection.layer_norm", proj["layer_norm"])
    return sd


CLAP_PREFIXES = ("clap.audio_encoder.", "audio_encoder.", "model.audio_encoder.")


def load_clap_ckpt(path_or_state_dict: Union[str, Mapping], version: str = "2023",
                   model: torch.nn.Module = None) -> torch.nn.Module:
    """Load an msclap checkpoint's audio tower (a file torch.load reads, or
    the state_dict itself) into `model` (default a new
    CLAPAudioEncoder(CLAPConfig(version))) by key name, after the first of
    CLAP_PREFIXES that the keys carry (the JAX convert_clap_audio :277).
    Keys the model does not hold (the text tower, the frontend's buffers,
    the tscam head) are ignored; a missing key raises KeyError, as does a
    checkpoint with no audio subtree."""
    from ..models.clap import CLAPAudioEncoder, CLAPConfig

    sd = path_or_state_dict
    if isinstance(sd, str):
        sd = torch.load(sd, map_location="cpu", weights_only=False)
        sd = sd.get("state_dict", sd.get("model", sd))
    pref = next((c for c in CLAP_PREFIXES if any(k.startswith(c) for k in sd)), None)
    if pref is None:
        raise KeyError("no audio_encoder subtree in CLAP checkpoint")
    sub = {k[len(pref):]: v for k, v in sd.items() if k.startswith(pref)}
    model = model if model is not None else CLAPAudioEncoder(CLAPConfig(version=version))
    own = model.state_dict()
    missing = [k for k in own if k not in sub]
    if missing:
        raise KeyError(f"the CLAP checkpoint lacks {len(missing)} keys, e.g. {missing[:3]}")
    model.load_state_dict({k: torch.as_tensor(sub[k]) for k in own})
    return model


def _efficientnet_sd(enc: dict, stats: Optional[dict]) -> Dict[str, torch.Tensor]:
    """A flax ColaEfficientNetEncoder subtree ({"cnn1", "efficientnet"})
    and its batch_stats (None for a gradient tree) -> the port's
    ColaEfficientNetEncoder state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    _conv_w(sd, "cnn1", enc["cnn1"])
    net = enc["efficientnet"]
    nst = stats["efficientnet"] if stats is not None else None

    def bn(key, tree, st):
        _bn_stats(sd, key, tree["BatchNorm_0"], st and st["BatchNorm_0"])

    e = "efficientnet."
    _conv_w(sd, e + "_conv_stem", net["_conv_stem"])
    bn(e + "_bn0", net["_bn0"], nst and nst["_bn0"])
    blocks = sorted(int(m[1]) for n in net if (m := re.fullmatch(r"_blocks_(\d+)", n)))
    for i in blocks:
        blk, bst, tp = net[f"_blocks_{i}"], nst and nst[f"_blocks_{i}"], f"{e}_blocks.{i}."
        for conv in ("_expand_conv", "_depthwise_conv", "_se_reduce", "_se_expand",
                     "_project_conv"):
            if conv in blk:
                _conv_w(sd, tp + conv, blk[conv])
        for norm in ("_bn0", "_bn1", "_bn2"):
            if norm in blk:
                bn(tp + norm, blk[norm], bst and bst[norm])
    _conv_w(sd, e + "_conv_head", net["_conv_head"])
    bn(e + "_bn1", net["_bn1"], nst and nst["_bn1"])
    return sd


def from_jax_efficientnet(variables: dict) -> Dict[str, torch.Tensor]:
    """flax Cola(efficientnet) variables -> state_dict of
    models.cola.Cola(encoder="efficientnet")."""
    params = variables["params"]
    stats = variables["batch_stats"]["encoder"] if "batch_stats" in variables else None
    sd = {f"encoder.{k}": v for k, v in _efficientnet_sd(params["encoder"], stats).items()}
    if "middle" in params:
        _linear(sd, "middle", params["middle"])
    if "g" in params:
        _linear(sd, "g", params["g"])
        _norm(sd, "layer_norm", params["layer_norm"])
        _linear(sd, "linear", params["linear"], bias=False)
    return sd


def load_cola_efficientnet_ckpt(path_or_state_dict: Union[str, Mapping],
                                model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference OPERA-CE Cola(efficientnet) checkpoint (a Lightning
    `.ckpt`, a bare state_dict file, or the dict itself) into the port's
    Cola(encoder="efficientnet") by key name: encoder.cnn1.*,
    encoder.efficientnet.* (efficientnet-pytorch's names), g, layer_norm,
    linear [, middle]. Keys the port does not hold (efficientnet-pytorch's
    _fc head) are ignored; a missing key raises KeyError."""
    sd = path_or_state_dict
    if isinstance(sd, str):
        sd = torch.load(sd, map_location="cpu", weights_only=False)
        sd = sd.get("state_dict", sd.get("model", sd))
    own = model.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"the OPERA-CE checkpoint lacks {len(missing)} keys, e.g. {missing[:3]}")
    model.load_state_dict({k: torch.as_tensor(sd[k]) for k in own})
    return model


def from_jax_vggish(variables: dict) -> Dict[str, torch.Tensor]:
    """flax VGGish variables -> state_dict of models.vggish.VGGish."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in variables["params"].items():
        if name.startswith("conv"):
            _conv_w(sd, name, p)
        else:
            _linear(sd, name, p)
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


def from_jax_classifier(variables: dict, encoder_kind: str) -> Dict[str, torch.Tensor]:
    """flax EncoderClassifier variables -> state_dict of
    train.finetune.EncoderClassifier (see the module doc)."""
    params = variables["params"]
    enc = params["encoder"]
    if encoder_kind == "htsat":
        inner = {"params": {"encoder": enc}}
        if "batch_stats" in variables and variables["batch_stats"]:
            inner["batch_stats"] = {"encoder": variables["batch_stats"]["encoder"]}
        sd = {k[len(HTSAT_PREFIX):]: v for k, v in from_jax(inner).items()}
    elif encoder_kind == "gt":
        sd = from_jax_mae({"params": enc["mae"]})
        sd["mask_token"] = _t(enc["mae"]["mask_token"])  # unread; in the L2 term
    elif encoder_kind == "audiomae":
        sd = from_jax_mae({"params": enc})
    elif encoder_kind == "efficientnet":
        stats = variables["batch_stats"]["encoder"] if variables.get("batch_stats") else None
        sd = _efficientnet_sd(enc, stats)
    elif encoder_kind in ("clap", "clap2023"):
        inner = {"params": enc}
        if variables.get("batch_stats"):
            inner["batch_stats"] = variables["batch_stats"]["encoder"]
        sd = from_jax_clap(inner, "2023" if encoder_kind == "clap2023" else "2022")
        if "tscam_conv" in enc["base"]:  # unread; in the L2 term
            _conv_w(sd, "base.htsat.tscam_conv", enc["base"]["tscam_conv"])
    elif encoder_kind == "hear":
        sd = from_jax_hear({"params": enc})
    else:
        raise ValueError(f"unknown encoder_kind {encoder_kind!r}")
    out = {f"encoder.{k}": v for k, v in sd.items()}
    out.update({f"head.{k}": v for k, v in from_jax_head(params["head"]).items()})
    return out
