"""Tensor ops with the JAX package's semantics (``semseg_tpu.ops``), NCHW."""

from .norm import batch_norm_inference
from .pool import adaptive_avg_pool2d, max_pool2d
from .resize import resize_bilinear

__all__ = [
    "adaptive_avg_pool2d",
    "batch_norm_inference",
    "max_pool2d",
    "resize_bilinear",
]
