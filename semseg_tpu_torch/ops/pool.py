"""Pooling with PyTorch semantics (``semseg_tpu/ops/pool.py``), NCHW.

* ``max_pool2d`` — the ResNet stem's ``MaxPool2d(3, 2, 1)``; padding acts as
  -inf, floor mode.
* ``adaptive_avg_pool2d`` — integer bins ``[floor(i*H/s), ceil((i+1)*H/s))``,
  summed in the accumulation dtype and cast back. The PPM head takes all its
  grids at once through ``ops.kernels.pyramid_pool``.
"""

from __future__ import annotations

import torch.nn.functional as F

from .dtypes import acc_dtype


def max_pool2d(x, *, kernel_size, stride, padding=0):
    """Max pool matching ``torch.nn.MaxPool2d`` (floor mode)."""
    return F.max_pool2d(x, kernel_size, stride, padding)


def adaptive_avg_pool2d(x, output_size):
    """Adaptive average pool matching ``torch.nn.AdaptiveAvgPool2d``."""
    return F.adaptive_avg_pool2d(x.to(acc_dtype(x.dtype)), output_size).to(x.dtype)
