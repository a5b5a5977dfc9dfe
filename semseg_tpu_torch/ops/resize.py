"""Bilinear resize (``semseg_tpu/ops/resize.py::resize_bilinear``), NCHW.

Half-pixel centres (``align_corners=False``) and no antialiasing: the
reference's ``F.interpolate(mode='bilinear')``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x, size):
    """Resize NCHW ``x`` spatially to ``size`` = (H, W), bilinear."""
    if tuple(size) == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


def resize_bilinear_rows(x, size, rows):
    """Rows ``rows`` = (r0, r1) of ``resize_bilinear(x, size)``, for a band
    of a map split by height (``parallel/spatial.py``), computed from the
    input rows they read: the width resized as ``resize_bilinear`` resizes
    it, then each output row as the weighted sum of its two input rows, with
    ``F.interpolate``'s indices and weights for ``align_corners=False``, as
    a product with an (r1 - r0, h_in) matrix (its backward adds in a fixed
    order, as an index's would not on a card). In float32 (float64 for a
    float64 ``x``), rounded once to ``x``'s dtype: the whole map's rows to
    rounding."""
    (h, w), (r0, r1), in_h = size, rows, x.shape[2]
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    dst = torch.arange(r0, r1, dtype=acc, device=x.device)
    src = ((dst + 0.5) * (in_h / h) - 0.5).clamp(min=0)[:, None]
    i0 = src.long().clamp(max=in_h - 1)
    l1 = src - i0
    k = torch.arange(in_h, device=x.device)
    m = (torch.where(k == i0, 1 - l1, 0.0)
         + torch.where(k == (i0 + 1).clamp(max=in_h - 1), l1, 0.0))
    t = resize_bilinear(x.to(acc), (in_h, w))
    return torch.einsum("rk,nckw->ncrw", m, t).to(x.dtype)
