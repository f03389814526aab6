"""Checkpoint registry and model factory — counterpart of
heart_murmur_detection_tpu/extract/registry.py: operaCT and its
continued-pretraining checkpoints by name (_CP_PATHS, get_encoder_path;
Cola(htsat)),
operaCE and the random baselines null / null-efficientnet
(Cola(efficientnet)), operaGT (the MAE ViT-S encoder), the audiomae kinds
(the Audio-MAE ViT-B backbone), hear (the HeAR ViT-L/16 encoder) and the
CLAP audio towers clap (2022, Cnn14) and clap2023 (HTS-AT).

Checkpoint paths mirror the reference's `cks/` layout (model_util.py:25-60),
so a user's existing `cks/` tree works unchanged. Nothing is downloaded: a
missing checkpoint raises the JAX package's FileNotFoundError with the
expected path. Random init draws from a seeded torch.Generator.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..models import clap, hear, vit_mae
from ..models.cola import Cola
from ..models.htsat import init_weights
from . import convert

ENCODER_PATH_OPERA_CE_EFFICIENTNET = "cks/model/encoder-operaCE.ckpt"
ENCODER_PATH_OPERA_CT_HT_SAT = "cks/model/encoder-operaCT.ckpt"
ENCODER_PATH_OPERA_GT_VIT = "cks/model/encoder-operaGT.ckpt"

_CP_DIR = "cks/model/combined"

# continued-pretraining checkpoints keyed as in model_util.py:28-60
_CP_PATHS = {
    "operaCT-heart-indomain-physionet16": f"{_CP_DIR}/physionet16/encoder-operaCT-physionet16-indomain-epoch=239--valid_acc=0.98-valid_loss=0.0524.ckpt",
    "operaCT-heart-indomain-circor": f"{_CP_DIR}/circor/encoder-operaCT-circor-indomain-epoch=209--valid_acc=0.99-valid_loss=0.0397.ckpt",
    "operaCT-heart-indomain-pretrained-physionet16": f"{_CP_DIR}/physionet16/encoder-operaCT-physionet16-indomain-pretrained-epoch=169--valid_acc=0.99-valid_loss=0.0300.ckpt",
    "operaCT-heart-indomain-pretrained-circor": f"{_CP_DIR}/circor/encoder-operaCT-circor-indomain-pretrained-epoch=229--valid_acc=0.99-valid_loss=0.0342.ckpt",
    "operaCT-heart-nonoisy-circor": f"{_CP_DIR}/pascal_A_pascal_B_physionet16_zchsound_clean/encoder-operaCT-nocircor-nonoisy-epoch=249--valid_acc=0.96-valid_loss=0.2138.ckpt",
    "operaCT-heart-nonoisy-pascal": f"{_CP_DIR}/circor_physionet16_zchsound_clean/encoder-operaCT-nopascal-nonoisy-epoch=159--valid_acc=0.94-valid_loss=0.3256.ckpt",
    "operaCT-heart-nonoisy-physionet16": f"{_CP_DIR}/circor_pascal_A_pascal_B_zchsound_clean/encoder-operaCT-nophysionet-nonoisy-epoch=249--valid_acc=0.95-valid_loss=0.2898.ckpt",
    "operaCT-heart-nonoisy-zchsound": f"{_CP_DIR}/circor_pascal_A_pascal_B_physionet16/encoder-operaCT-nozchsound-epoch=169--valid_acc=0.94-valid_loss=0.3174.ckpt",
    "operaCT-heart-all": f"{_CP_DIR}/circor_pascal_A_pascal_B_physionet16_zchsound_clean_zchsound_noisy/encoder-operaCT-heart-all-epoch=159--valid_acc=0.94-valid_loss=0.3790.ckpt",
    "operaCT-heart-all-scratch": f"{_CP_DIR}/circor_pascal_A_pascal_B_physionet16_zchsound_clean_zchsound_noisy/encoder-operaCT-heart-all-scratch-epoch=209--valid_acc=0.92-valid_loss=0.3899.ckpt",
    "operaCT-heart-cross-circor": f"{_CP_DIR}/pascal_A_pascal_B_physionet16_zchsound_clean_zchsound_noisy/model.ckpt",
    "operaCT-heart-cross-pascal": f"{_CP_DIR}/circor_physionet16_zchsound_clean_zchsound_noisy/model.ckpt",
    "operaCT-heart-cross-zchsound": f"{_CP_DIR}/circor_pascal_A_pascal_B_physionet16/model.ckpt",
    "operaCT-heart-cross-physionet16": f"{_CP_DIR}/circor_pascal_A_pascal_B_zchsound_clean_zchsound_noisy/model.ckpt",
}

_AUDIOMAE_PATHS = {
    "audiomae": "src/benchmark/baseline/audioMAE/pretrained.pth",
    "audiomae-heart-all": f"{_CP_DIR}/circor_pascal_A_pascal_B_physionet16_zchsound_clean_zchsound_noisy/encoder-audiomae-heart-all-epoch=269--valid_acc=0.00-valid_loss=0.8422.ckpt",
    "audiomae-heart-circor-indomain": f"{_CP_DIR}/circor/encoder-audiomae-heart-circor-indomain-epoch=389--valid_acc=0.00-valid_loss=1.0124.ckpt",
    "audiomae-heart-nozchsound": f"{_CP_DIR}/circor_pascal_A_pascal_B_physionet16/encoder-audiomae-heart-nozchsound-epoch=289--valid_acc=0.00-valid_loss=0.8262.ckpt",
    "audiomae-heart-nophysionet16": f"{_CP_DIR}/circor_pascal_A_pascal_B_zchsound_clean_zchsound_noisy/encoder-audiomae-heart-nophysionet16-epoch=329--valid_acc=0.00-valid_loss=0.9945.ckpt",
    "audiomae-heart-nopascal": f"{_CP_DIR}/circor_physionet16_zchsound_clean_zchsound_noisy/encoder-audiomae-heart-nopascal-epoch=329--valid_acc=0.00-valid_loss=0.8338.ckpt",
    "audiomae-heart-nocircor": f"{_CP_DIR}/pascal_A_pascal_B_physionet16_zchsound_clean_zchsound_noisy/encoder-audiomae-heart-nocircor-epoch=429--valid_acc=0.00-valid_loss=0.6585.ckpt",
    "audiomae-heart-physionet16-indomain": f"{_CP_DIR}/physionet16/encoder-audiomae-heart-physionet16-indomain-epoch=459--valid_acc=0.00-valid_loss=0.5994.ckpt",
    "audiomae-heart-all-scratch": f"{_CP_DIR}/circor_pascal_A_pascal_B_physionet16_zchsound_clean_zchsound_noisy/encoder-audiomae-heart-all-scratch-epoch=389--valid_acc=0.00-valid_loss=1.1551.ckpt",
}


def is_operact(pretrain: str) -> bool:
    return "operaCT" in pretrain or pretrain == "null-htsat"


def is_operace(pretrain: str) -> bool:
    """The EfficientNet kinds (JAX registry.py:132-137)."""
    return pretrain in ("operaCE", "null", "null-efficientnet")


def is_operagt(pretrain: str) -> bool:
    return pretrain == "operaGT"


def is_audiomae(pretrain: str) -> bool:
    return "audiomae" in pretrain


def is_hear(pretrain: str) -> bool:
    return pretrain == "hear"


def is_clap(pretrain: str) -> bool:
    return pretrain in ("clap", "clap2023")


def default_input_sec(pretrain: str, min_len_htsat: float = 8, min_len_cnn: float = 8):
    """Per-model window policy (circor_processing.py:325-343); a copy of
    heart_murmur_detection_tpu/data/processors/common.py::default_input_sec."""
    if "operaCT" in pretrain:
        return min_len_htsat
    if pretrain == "operaCE":
        return min_len_cnn
    if pretrain == "operaGT":
        return 8.18
    if "audiomae" in pretrain:
        return 10
    return 8


def _missing(pretrain: str, path: str):
    return FileNotFoundError(
        f"checkpoint for '{pretrain}' not found at {path}; place the checkpoint there"
    )


def _encoder_paths() -> dict:
    paths = {
        "operaCT": ENCODER_PATH_OPERA_CT_HT_SAT,
        "operaCE": ENCODER_PATH_OPERA_CE_EFFICIENTNET,
        "operaGT": ENCODER_PATH_OPERA_GT_VIT,
        **_CP_PATHS,
    }
    # the zchsound_clean / zchsound_noisy variants share the zchsound CP checkpoint
    for suffix in ("zchsound_clean", "zchsound_noisy"):
        paths[f"operaCT-heart-nonoisy-{suffix}"] = _CP_PATHS["operaCT-heart-nonoisy-zchsound"]
        paths[f"operaCT-heart-cross-{suffix}"] = _CP_PATHS["operaCT-heart-cross-zchsound"]
    return paths


def get_encoder_path(pretrain: str) -> str:
    """The checkpoint path of an OPERA encoder or a continued-pretraining
    name (the JAX get_encoder_path :63-86, without its download): KeyError
    for an unknown name, FileNotFoundError where the file is missing."""
    paths = _encoder_paths()
    if pretrain not in paths:
        raise KeyError(f"unknown pretrain: {pretrain}")
    path = paths[pretrain]
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint for '{pretrain}' not found at {path}; "
            "run pretraining or place the checkpoint there"
        )
    return path


def get_audiomae_encoder_path(pretrain: str) -> str:
    """The checkpoint path of an Audio-MAE name (the JAX :89-95)."""
    if pretrain not in _AUDIOMAE_PATHS:
        raise KeyError(f"unknown audiomae pretrain: {pretrain}")
    path = _AUDIOMAE_PATHS[pretrain]
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    return path


def initialize_pretrained_model(
    pretrain: str,
    ckpt_path: Optional[str] = None,
    random_init: bool = False,
    seed: int = 0,
) -> torch.nn.Module:
    """Build the model for `pretrain` on the CPU and load its weights:
    random (seeded) for random_init or a null-* pretrain, else from
    ckpt_path (default: the name's path, get_encoder_path or
    get_audiomae_encoder_path, as the JAX :155-159 resolves it). operaCT
    kinds (operaCT and every continued-pretraining name) give a Cola(htsat)
    whose checkpoint convert.load_torch_ckpt reads (a fine-tuned
    classifier's too: its encoder, the rest of the seeded init kept),
    operaCE, null and null-efficientnet a
    Cola(efficientnet) (operaCE's checkpoint a reference Cola(efficientnet)
    state_dict, default cks/model/encoder-operaCE.ckpt), operaGT a MaskedAutoencoderViT
    (ViT-S), the audiomae kinds an AudioMAEClassifierBackbone (ViT-B/16),
    hear a HeAREncoder (ViT-L/16; its checkpoint is a Hugging Face
    google/hear-pytorch state_dict at ckpt_path, which has no default: the
    reference downloads it), clap / clap2023 a CLAPAudioEncoder (its
    checkpoint an msclap state_dict at ckpt_path, no default either). Other
    names raise NotImplementedError."""
    gen = torch.Generator().manual_seed(seed)
    if is_clap(pretrain):
        if not random_init and (ckpt_path is None or not os.path.exists(ckpt_path)):
            raise _missing(pretrain, ckpt_path or "ckpt_path (msclap state_dict)")
        version = "2023" if pretrain == "clap2023" else "2022"
        model = clap.CLAPAudioEncoder(clap.CLAPConfig(version=version))
        if random_init:
            return clap.init_weights(model, gen).eval()
        return convert.load_clap_ckpt(ckpt_path, version, model).eval()
    if is_hear(pretrain):
        if not random_init and (ckpt_path is None or not os.path.exists(ckpt_path)):
            raise _missing(pretrain, ckpt_path or "ckpt_path (google/hear-pytorch state_dict)")
        model = hear.HeAREncoder(hear.HeARConfig())
        if random_init:
            hear.init_weights(model, gen)
            return model.eval()
        return convert.load_hear_ckpt(ckpt_path, model).eval()
    if is_operagt(pretrain) or is_audiomae(pretrain):
        if is_operagt(pretrain):
            model = vit_mae.MaskedAutoencoderViT(vit_mae.mae_vit_small_config())
            resolve = get_encoder_path
        else:
            model = vit_mae.AudioMAEClassifierBackbone(vit_mae.audiomae_base_config())
            resolve = get_audiomae_encoder_path
        if random_init:
            vit_mae.init_weights(model, gen)
            return model.eval()
        ckpt_path = ckpt_path or resolve(pretrain)
        if not os.path.exists(ckpt_path):
            raise _missing(pretrain, ckpt_path)
        return convert.load_mae_ckpt(ckpt_path, model).eval()
    if is_operace(pretrain):
        model = Cola(encoder="efficientnet")
        if random_init or pretrain.startswith("null"):
            init_weights(model, gen)
            return model.eval()
        ckpt_path = ckpt_path or get_encoder_path("operaCE")
        if not os.path.exists(ckpt_path):
            raise _missing(pretrain, ckpt_path)
        return convert.load_cola_efficientnet_ckpt(ckpt_path, model).eval()
    if not is_operact(pretrain):
        raise NotImplementedError(f"Model not found: {pretrain}")
    model = Cola()
    if random_init or pretrain.startswith("null"):
        init_weights(model, gen)
        return model.eval()
    ckpt_path = ckpt_path or get_encoder_path(pretrain)
    if not os.path.exists(ckpt_path):
        raise _missing(pretrain, ckpt_path)
    init_weights(model, gen)  # what a checkpoint leaves out keeps the seeded init
    return convert.load_torch_ckpt(ckpt_path, model).eval()
