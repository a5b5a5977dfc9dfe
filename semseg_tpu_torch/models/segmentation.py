"""Encoder → decoder glue with the loss (``semseg_tpu/models/segmentation.py``).

* ``model(img, seg_label=label)``, the training forward: logits at decoder
  resolution, the masked softmax cross-entropy (ignore index -1) plus
  ``deep_sup_scale`` times the deep-supervision term where the decoder has
  one and is in training mode; returns ``(loss, acc)``, float32 scalars.
* ``model(img, seg_size)``: per-pixel softmax scores (N, num_class, H, W)
  at ``seg_size``, the reference's ``segSize`` branch.
* ``model(img)``: float32 logits at decoder resolution, the bucketed
  engines' call; ``valid_hw`` ((N, 2) int32, each image's true pixels
  inside its padded canvas) is turned into per-feature-map extents by
  ceiling division by each map's stride, so the decoder can pool
  padding-exactly. Training pools the whole canvas, as the JAX package
  does (the reference trains on zero-padded canvases).

``train()`` with ``fix_bn`` (``TRAIN.fix_bn``) puts the model in training
mode but leaves every batch norm and dropout in eval mode: the running
statistics stay frozen and the deep-supervision branch still runs, the JAX
package's ``train`` / ``norm_train`` split.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from semseg_tpu_torch.ops.losses import pixel_accuracy, softmax_cross_entropy_with_ignore
from .layers import BatchNorm2d, Dropout2d


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
    def __init__(self, encoder: nn.Module, decoder: nn.Module, *,
                 deep_sup_scale: Optional[float] = None, fix_bn: bool = False,
                 ignore_index: int = -1):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.deep_sup_scale = deep_sup_scale
        self.fix_bn = fix_bn
        self.ignore_index = ignore_index

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.fix_bn:
            for m in self.modules():
                if isinstance(m, (BatchNorm2d, Dropout2d)):
                    m.eval()
        return self

    def forward(self, img, seg_size=None, valid_hw=None, *, seg_label=None):
        feats = self.encoder(img)
        if seg_size is not None:
            return self.decoder(feats, seg_size)
        if seg_label is None:
            vh = None
            if valid_hw is not None:
                vh = feature_extents(valid_hw, img.shape[2:], feats)
            return self.decoder(feats, valid_hw=vh)

        out = self.decoder(feats)
        logits, logits_deepsup = out if isinstance(out, tuple) else (out, None)
        loss = softmax_cross_entropy_with_ignore(logits, seg_label,
                                                 ignore_index=self.ignore_index)
        if logits_deepsup is not None and self.deep_sup_scale is not None:
            loss = loss + self.deep_sup_scale * softmax_cross_entropy_with_ignore(
                logits_deepsup, seg_label, ignore_index=self.ignore_index)
        acc = pixel_accuracy(logits, seg_label, ignore_index=self.ignore_index)
        return loss, acc
