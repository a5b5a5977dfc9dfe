"""Bilinear resize (``semseg_tpu/ops/resize.py::resize_bilinear``), NCHW.

Half-pixel centres (``align_corners=False``) and no antialiasing: the
reference's ``F.interpolate(mode='bilinear')``.
"""

from __future__ import annotations

import torch.nn.functional as F


def resize_bilinear(x, size):
    """Resize NCHW ``x`` spatially to ``size`` = (H, W), bilinear."""
    if tuple(size) == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)
