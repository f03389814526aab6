"""heart_murmur_detection_tpu_torch — the PyTorch / CUDA port of
heart_murmur_detection_tpu, for one NVIDIA Hopper card (H100, sm_90a).

The JAX package beside it stays the reference; module paths and function
names here mirror it so each counterpart is easy to find. This package
imports torch and never jax or flax, so host helpers the port needs are
copied (and pinned to their originals by tests), not imported.

Layer map (the operaCT serving slice):
  utils/    numpy WAV IO
  audio/    host pad/trim pipelines, wire formats, device DSP (torch)
  ops/      hand-written CUDA swin kernels (csrc/), their plain torch
            versions, the nvcc build and ctypes binding
  models/   HTS-AT (operaCT) with reference state_dict keys, the fused
            forward routed through ops/, the COLA wrapper
  extract/  weight conversion, model registry, batched FeatureExtractor
  cli/      key=value config loader and the serving daemon
"""

__version__ = "0.1.0"
