"""Float32 precision of the strict paths."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def strict_f32():
    """TF32 off for float32 matmuls and convolutions inside the block (the
    JAX package's float32 graphs run them in full float32)."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
