"""Inference batch norm (``semseg_tpu/ops/norm.py::batch_norm_inference``).

``(x - running_mean) / sqrt(running_var + eps) * weight + bias``, folded into
one affine computed in the accumulation dtype and cast back to ``x.dtype``.
The training half (clamped-eps normalisation, bias-corrected EMA) comes with
the training port.
"""

from __future__ import annotations

import torch

from .dtypes import acc_dtype


def batch_norm_inference(x, weight, bias, running_mean, running_var, *, eps=1e-5):
    """Batch norm with running statistics over the channels of NCHW ``x``."""
    adt = acc_dtype(x.dtype)
    inv = torch.rsqrt(running_var + eps)
    w = (weight * inv).to(adt).view(1, -1, 1, 1)
    b = (bias - running_mean * weight * inv).to(adt).view(1, -1, 1, 1)
    return (x.to(adt) * w + b).to(x.dtype)
