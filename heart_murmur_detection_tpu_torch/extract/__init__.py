from . import convert, registry
from .extract import FeatureExtractor, extract_audiomae_feature, extract_opera_feature
from .registry import (
    get_audiomae_encoder_path,
    get_encoder_path,
    initialize_pretrained_model,
)
