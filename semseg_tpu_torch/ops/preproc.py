"""On-device image preprocessing (``semseg_tpu/ops/preproc.py``).

uint8 → ImageNet-normalized float32, ``(x/255 - MEAN) / STD``, as the host
pipeline (``data/transforms.img_transform``) computes it, with the canvas
padding ZEROED IN NORMALIZED SPACE: the reference pads normalized images
with zeros, so pad must be 0, not the normalized value of black. Images keep
the JAX package's (N, H, W, 3) layout here; the NHWC result seen through
``permute(0, 3, 1, 2)`` is an NCHW channels_last tensor without a copy.
"""

from __future__ import annotations

import functools

import torch

from semseg_tpu_torch.data.transforms import MEAN, STD


@functools.lru_cache(maxsize=None)
def _mean_std(device: torch.device):
    """MEAN and STD as float32 tensors on ``device``, copied there once: a
    host-to-device copy from pageable memory waits for the card's queue to
    drain, which would stall every train step and eval chunk."""
    return (torch.tensor(MEAN, dtype=torch.float32, device=device),
            torch.tensor(STD, dtype=torch.float32, device=device))


def normalize_255(x: torch.Tensor) -> torch.Tensor:
    """float32 pixels in [0, 255] (..., 3) → ImageNet-normalized."""
    mean, std = _mean_std(x.device)
    return (x / 255.0 - mean) / std


def valid_mask(shape, h, w, *, batch_dims: int = 0, device=None) -> torch.Tensor:
    """Boolean (..., H, W) mask of the valid region.

    ``shape``: the (H, W)-trailing spatial shape, e.g. ``(N, H, W)`` with
    ``batch_dims=1`` and per-image ``h``/``w`` of length N, or ``(H, W)``
    with scalars and ``batch_dims=0``.
    """
    hh, ww = shape[batch_dims], shape[batch_dims + 1]
    ih = torch.arange(hh, device=device).view(hh, 1)
    iw = torch.arange(ww, device=device).view(1, ww)
    h = torch.as_tensor(h, device=device)
    w = torch.as_tensor(w, device=device)
    if batch_dims:
        h = h.view(*h.shape, 1, 1)
        w = w.view(*w.shape, 1, 1)
    return ((ih < h) & (iw < w)).expand(tuple(shape))


def normalize_u8_masked(img_u8: torch.Tensor, h, w) -> torch.Tensor:
    """Normalize a (N, H, W, 3) or (H, W, 3) uint8 canvas to float32 and
    zero the region outside ``h``/``w`` (scalars, or length-N tensors for
    the batched form)."""
    x = normalize_255(img_u8.to(torch.float32))
    batch_dims = img_u8.dim() - 3
    mask = valid_mask(img_u8.shape[:-1], h, w, batch_dims=batch_dims,
                      device=img_u8.device)
    return torch.where(mask[..., None], x, 0.0)
