"""Resize and adaptive-pool matrices with runtime valid sizes
(``semseg_tpu/ops/resize_dynamic.py``).

The batched engines run images of different true sizes inside padded bucket
canvases. These ops keep the global operations exact on such canvases:

* ``resize_matrix``: dense bilinear interpolation matrix (half-pixel
  centres, edge clamping, no antialiasing: ``F.interpolate(bilinear,
  align_corners=False)``) whose shape is the padded one while the true
  sizes are runtime values; columns past ``in_valid`` are zero.
* ``pil_resize_matrix``: Pillow's antialiased BILINEAR filter as such a
  matrix (the device-pyramid engine's level derivation).
* ``adaptive_pool_matrix`` / ``adaptive_avg_pool2d_valid``: PyTorch's
  ``AdaptiveAvgPool2d`` with bins ``[floor(g*v/s), ceil((g+1)*v/s))`` over
  the VALID extent ``v`` only. The PPM head takes all four of its grids at
  once through ``ops.kernels.pyramid_pool(..., valid_hw=...)``, whose plain
  version is this function.
* ``upsample_grid_valid``: place a pooled s×s grid back onto the valid
  region of a padded canvas; zero beyond it.

The formulas are the JAX package's, in float32. A valid size may be a
Python number or a tensor; a tensor of shape (N,) gives N matrices (the
batch dimension JAX writes with ``vmap``). Images and maps keep the JAX
package's (N, H, W, C) layout; everything accumulates in float32 and
returns the input dtype.
"""

from __future__ import annotations

import torch


def _valid(v, device) -> torch.Tensor:
    """A valid size as float32, shaped to broadcast over (rows, cols)."""
    v = torch.as_tensor(v, device=device).to(torch.float32)
    return v.view(*v.shape, 1, 1)


def resize_matrix(out_pad: int, in_pad: int, out_valid, in_valid, *,
                  device=None) -> torch.Tensor:
    """(..., out_pad, in_pad) bilinear matrix for runtime sizes.

    Rows past ``out_valid`` still hold (clamped) weights; mask the output
    if those rows matter.
    """
    i = torch.arange(out_pad, dtype=torch.float32, device=device).view(-1, 1)
    k = torch.arange(in_pad, dtype=torch.float32, device=device).view(1, -1)
    out_valid = _valid(out_valid, device)
    in_valid = _valid(in_valid, device)
    src = (i + 0.5) * (in_valid / out_valid) - 0.5
    src = torch.minimum(torch.clamp(src, min=0.0), in_valid - 1.0)
    w = torch.clamp(1.0 - (src - k).abs(), min=0.0)
    return torch.where(k < in_valid, w, 0.0)


def pil_resize_matrix(out_pad: int, in_pad: int, out_valid, in_valid, *,
                      device=None) -> torch.Tensor:
    """(..., out_pad, in_pad) antialiased bilinear (triangle-filter) matrix
    for runtime sizes (``semseg_tpu/engine.py::_pil_resize_matrix``).

    Pillow's BILINEAR resampling (the reference's ``imresize``): the filter
    support scales with the downsampling ratio and windows clipped at the
    border renormalize; for upscaling it is half-pixel-centre bilinear.
    Columns past ``in_valid`` are zero.
    """
    i = torch.arange(out_pad, dtype=torch.float32, device=device).view(-1, 1)
    k = torch.arange(in_pad, dtype=torch.float32, device=device).view(1, -1)
    out_valid = _valid(out_valid, device)
    in_valid = _valid(in_valid, device)
    scale = in_valid / out_valid
    support = torch.clamp(scale, min=1.0)
    center = (i + 0.5) * scale
    w = torch.clamp(1.0 - (k + 0.5 - center).abs() / support, min=0.0)
    w = torch.where(k < in_valid, w, 0.0)
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)


def adaptive_pool_matrix(grid: int, in_pad: int, in_valid, *,
                         device=None) -> torch.Tensor:
    """(..., grid, in_pad) averaging matrix: bin ``g`` spans
    ``[floor(g*v/grid), ceil((g+1)*v/grid))`` of the first ``in_valid``
    positions and averages uniformly."""
    g = torch.arange(grid, dtype=torch.float32, device=device).view(-1, 1)
    k = torch.arange(in_pad, dtype=torch.float32, device=device).view(1, -1)
    v = _valid(in_valid, device)
    start = torch.floor(g * v / grid)
    end = torch.ceil((g + 1) * v / grid)
    m = ((k >= start) & (k < end)).to(torch.float32)
    return m / torch.clamp(end - start, min=1.0)


def adaptive_avg_pool2d_valid(x: torch.Tensor, output_size,
                              valid_hw: torch.Tensor) -> torch.Tensor:
    """Per-sample valid-region ``AdaptiveAvgPool2d`` on padded canvases.

    ``x``: (N, H_pad, W_pad, C); ``valid_hw``: (N, 2) int, each sample's
    true extent. Equals ``adaptive_avg_pool2d(x[n, :h, :w], output_size)``
    for every sample, up to summation order. Returns (N, oh, ow, C).
    """
    oh, ow = (output_size if isinstance(output_size, (tuple, list))
              else (output_size, output_size))
    _, hp, wp, _ = x.shape
    mh = adaptive_pool_matrix(oh, hp, valid_hw[:, 0], device=x.device)
    mw = adaptive_pool_matrix(ow, wp, valid_hw[:, 1], device=x.device)
    p = torch.einsum("nik,nkwc->niwc", mh, x.to(torch.float32))
    return torch.einsum("njw,niwc->nijc", mw, p).to(x.dtype)


def upsample_grid_valid(p: torch.Tensor, out_hw, valid_hw: torch.Tensor) -> torch.Tensor:
    """Bilinear-upsample a pooled (N, s, s, C) grid onto the valid region of
    an (N, H_pad, W_pad, C) canvas, zero beyond it; NHWC-contiguous.

    Matches ``F.interpolate(grid, (h, w), bilinear, align_corners=False)``
    on the unpadded map (reference models.py:417-421).
    """
    hp, wp = out_hw
    _, gh, gw, _ = p.shape
    mh = resize_matrix(hp, gh, valid_hw[:, 0], gh, device=p.device)
    mw = resize_matrix(wp, gw, valid_hw[:, 1], gw, device=p.device)
    r = torch.einsum("nik,nkwc->niwc", mh, p.to(torch.float32))
    r = torch.einsum("njw,niwc->nijc", mw, r)
    ii = torch.arange(hp, device=p.device).view(1, hp, 1, 1)
    jj = torch.arange(wp, device=p.device).view(1, 1, wp, 1)
    inside = (ii < valid_hw[:, 0].view(-1, 1, 1, 1)) & (jj < valid_hw[:, 1].view(-1, 1, 1, 1))
    return torch.where(inside, r, 0.0).to(p.dtype).contiguous()
