"""Encoder → decoder glue (``semseg_tpu/models/segmentation.py``).

Inference only. ``model(img, seg_size)`` returns per-pixel softmax scores
(N, num_class, H, W) at ``seg_size``, the reference's ``segSize`` branch.
``model(img)`` returns float32 logits at decoder resolution, the bucketed
engines' call; ``valid_hw`` ((N, 2) int32, each image's true pixels inside
its padded canvas) is turned into per-feature-map extents by ceiling
division by each map's stride, so the decoder can pool padding-exactly.
The training forward (loss, deep supervision) comes with the training port.
"""

from __future__ import annotations

import torch
from torch import nn


def feature_extents(valid_hw, img_hw, feats):
    """Per-feature-map (N, 2) extents: ``ceil(valid / stride)`` with each
    map's stride taken from the padded image and map shapes."""
    out = []
    for f in feats:
        sh, sw = img_hw[0] // f.shape[2], img_hw[1] // f.shape[3]
        out.append(torch.stack([
            (valid_hw[:, 0] + sh - 1) // sh,
            (valid_hw[:, 1] + sw - 1) // sw,
        ], dim=-1).to(torch.int32).contiguous())
    return out


class SegmentationModel(nn.Module):
    def __init__(self, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder

    def forward(self, img, seg_size=None, valid_hw=None):
        feats = self.encoder(img)
        if seg_size is not None:
            return self.decoder(feats, seg_size)
        vh = None
        if valid_hw is not None:
            vh = feature_extents(valid_hw, img.shape[2:], feats)
        return self.decoder(feats, valid_hw=vh)
