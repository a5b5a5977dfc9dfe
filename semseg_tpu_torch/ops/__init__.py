"""Tensor ops with the JAX package's semantics (``semseg_tpu.ops``), NCHW."""

from .losses import nll_loss, pixel_accuracy, softmax_cross_entropy_with_ignore
from .norm import batch_norm_inference, batch_norm_train
from .pool import adaptive_avg_pool2d, max_pool2d
from .resize import resize_bilinear

__all__ = [
    "adaptive_avg_pool2d",
    "batch_norm_inference",
    "batch_norm_train",
    "max_pool2d",
    "nll_loss",
    "pixel_accuracy",
    "resize_bilinear",
    "softmax_cross_entropy_with_ignore",
]
