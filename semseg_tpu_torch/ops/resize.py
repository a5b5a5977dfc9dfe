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


def resize_bilinear_rows(x, size, rows, row0=0, in_h=None):
    """Rows ``rows`` = (r0, r1) of ``resize_bilinear(whole, size)``, for a
    band of a map split by height (``parallel/spatial.py``), where ``x``
    holds rows ``[row0, row0 + x.shape[2])`` of the ``in_h``-row map
    ``whole`` (by default ``x`` is the whole map), which must include every
    row the output rows read. Computed from those rows: the width resized
    as ``resize_bilinear`` resizes it, then each output row as the weighted
    sum of its two input rows, with ``F.interpolate``'s indices and weights
    for ``align_corners=False`` over the whole map's height, as a product
    with an (r1 - r0, x rows) matrix (its backward adds in a fixed order, as
    an index's would not on a card). In float32 (float64 for a float64
    ``x``), rounded once to ``x``'s dtype: the whole map's rows to rounding.
    Channels-last in memory."""
    (h, w), (r0, r1), hx = size, rows, x.shape[2]
    in_h = hx if in_h is None else in_h
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    dst = torch.arange(r0, r1, dtype=acc, device=x.device)
    src = ((dst + 0.5) * (in_h / h) - 0.5).clamp(min=0)[:, None]
    i0 = src.long().clamp(max=in_h - 1)
    l1 = src - i0
    k = torch.arange(row0, row0 + hx, device=x.device)
    m = (torch.where(k == i0, 1 - l1, 0.0)
         + torch.where(k == (i0 + 1).clamp(max=in_h - 1), l1, 0.0))
    t = resize_bilinear(x.to(acc), (hx, w)).permute(0, 2, 3, 1)
    return torch.einsum("rk,nkwc->nrwc", m, t).to(x.dtype).permute(0, 3, 1, 2)
