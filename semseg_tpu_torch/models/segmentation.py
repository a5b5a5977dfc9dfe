"""Encoder → decoder glue (``semseg_tpu/models/segmentation.py``).

Inference only: ``model(img, seg_size)`` returns per-pixel softmax scores
(N, num_class, H, W) at ``seg_size``, the reference's ``segSize`` branch.
The training forward (loss, deep supervision) comes with the training port.
"""

from __future__ import annotations

from torch import nn


class SegmentationModel(nn.Module):
    def __init__(self, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder

    def forward(self, img, seg_size):
        return self.decoder(self.encoder(img), seg_size)
