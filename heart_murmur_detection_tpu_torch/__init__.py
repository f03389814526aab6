"""heart_murmur_detection_tpu_torch — the PyTorch / CUDA port of
heart_murmur_detection_tpu, for one NVIDIA Hopper card (H100, sm_90a).

The JAX package beside it stays the reference; module paths and function
names here mirror it so each counterpart is easy to find. This package
imports torch and never jax or flax, so host helpers the port needs are
copied (and pinned to their originals by tests), not imported.

Layer map (operaCT serving and COLA pretraining, operaGT / audiomae
extraction):
  utils/    numpy WAV IO, the C++ host loader (native/hmdt_native.cpp,
            built at first use), metadata tables read as pandas reads them
  audio/    host pad/trim/split pipelines, wire formats, device DSP (torch:
            mel, kaldi fbank, resize), the host emobase functionals
  ops/      hand-written CUDA swin and ViT kernels (csrc/), their plain
            torch versions, the nvcc build and ctypes binding
  models/   HTS-AT (operaCT) and the MAE ViT encoders with reference
            state_dict keys, the fused forwards routed through ops/, COLA;
            the convolutional towers on cuDNN (EfficientNet-B0 of operaCE,
            VGGish, CLAP-2022's Cnn14) with flax BatchNorm semantics
  extract/  weight conversion, model registry, batched FeatureExtractor
  data/     the heart and respiratory processors, raw splits, numpy copies of
            sklearn's splitters and scaler
  train/    the probes (classification and LOOCV regression), the legacy
            OPERA task functions, fine-tuning, checkpoint re-evaluation
  pretrain/ COLA and MAE continued pretraining, SSL data preparation
  cli/      key=value config loader, the serving daemon, pretraining
"""

__version__ = "0.1.0"
