"""PPM decoders (``semseg_tpu/models/decoders.py``), NCHW, inference path.

With ``seg_size=(H, W)`` the logits are cast to float32, resized bilinearly
to ``seg_size`` and turned into softmax probabilities, as the reference's
``segSize`` protocol does. With ``seg_size=None`` they come back as float32
logits at decoder resolution (the bucketed engines' call). The four
pyramid pools run in one call of the hand-written kernel
``ops.kernels.pyramid_pool`` on the NHWC view of conv5.

``valid_hw`` (per feature map, (N, 2) int32: each sample's true extent
inside a padded bucket canvas) makes the pyramid branches pad-aware, as
``_PPMPool`` is in the JAX package: the pools bin over the valid region
only and each pooled grid is upsampled back onto that region, zero beyond
it, so the global pools never ingest the canvas padding.

Slot names follow the reference: ``ppm.{i}`` is ``Sequential(pool, conv,
BN, ReLU)``, ``conv_last`` is ``Sequential(conv, BN, ReLU, Dropout2d,
conv)``. The deep-supervision parameters (``cbr_deepsup``,
``conv_last_deepsup``) exist so that checkpoints load strict; inference
never runs them.
"""

from __future__ import annotations

import torch
from torch import nn

from semseg_tpu_torch.ops.dtypes import acc_dtype
from semseg_tpu_torch.ops.kernels.ppm_pool import SCALES, pyramid_pool
from semseg_tpu_torch.ops.resize import resize_bilinear
from semseg_tpu_torch.ops.resize_dynamic import upsample_grid_valid
from .layers import BatchNorm2d, Conv2d, ConvBN, Dropout2d, _Act


def _finish(x, seg_size):
    """Inference epilogue: upsample logits to label size, softmax, f32."""
    x = resize_bilinear(x.to(acc_dtype(x.dtype)), seg_size)
    return torch.softmax(x, dim=1)


class PPM(nn.Module):
    """Pyramid pooling head (reference models.py:389-434)."""

    def __init__(self, num_class: int = 150, fc_dim: int = 4096):
        super().__init__()
        # Slot 0 names the branch's grid; the pooling itself runs fused for
        # all branches in forward().
        self.ppm = nn.ModuleList(
            nn.Sequential(
                nn.AdaptiveAvgPool2d(scale),
                Conv2d(fc_dim, 512, 1, bias=False),
                BatchNorm2d(512),
                _Act("relu"),
            )
            for scale in SCALES
        )
        self.conv_last = nn.Sequential(
            *ConvBN(fc_dim + len(SCALES) * 512, 512, 3),
            Dropout2d(0.1),
            Conv2d(512, num_class, 1),
        )

    def forward(self, conv_out, seg_size=None, valid_hw=None):
        conv5 = conv_out[-1]
        h, w = conv5.shape[2:]
        valid = None if valid_hw is None else valid_hw[-1]
        pooled = pyramid_pool(conv5.permute(0, 2, 3, 1), SCALES, valid_hw=valid)
        pyramid = [conv5]
        for branch, p in zip(self.ppm, pooled):
            y = branch[1:](p.permute(0, 3, 1, 2))
            if valid is None:
                pyramid.append(resize_bilinear(y, (h, w)))
            else:
                up = upsample_grid_valid(y.permute(0, 2, 3, 1), (h, w), valid)
                pyramid.append(up.permute(0, 3, 1, 2))
        x = self.conv_last(torch.cat(pyramid, dim=1))
        if seg_size is not None:
            return _finish(x, seg_size)
        return x.to(acc_dtype(x.dtype))


class PPMDeepsup(PPM):
    """PPM with the deep-supervision branch off conv4 (models.py:438-495)."""

    def __init__(self, num_class: int = 150, fc_dim: int = 4096):
        super().__init__(num_class, fc_dim)
        self.cbr_deepsup = ConvBN(fc_dim // 2, fc_dim // 4, 3)
        self.dropout_deepsup = Dropout2d(0.1)
        self.conv_last_deepsup = Conv2d(fc_dim // 4, num_class, 1)
