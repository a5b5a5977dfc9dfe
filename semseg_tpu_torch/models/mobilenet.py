"""MobileNetV2 encoder (``semseg_tpu/models/mobilenet.py``), NCHW.

* inverted-residual setting (t, c, n, s) below, ReLU6, a residual only when
  the stride is 1 and the widths match; the depthwise 3x3 conv has
  ``groups = hidden``;
* the segmentation trunk drops the final 1x1 320→1280 conv, so ``fc_dim``
  is 320;
* dilation surgery for output stride 8: blocks [7, 14) get dilation 2 and
  [14, 18) dilation 4; within a dilated group the formerly strided
  depthwise conv gets ``d // 2`` and the rest ``d`` (``block_specs``);
* feature maps after blocks ``DOWN_IDX = (2, 4, 7, 14)`` plus the last one,
  five maps of 24, 32, 64, 160 and 320 channels; C1DeepSup's
  deep-supervision branch reads ``conv_out[-2]``.

``banded_features`` is the forward of an image split in row bands across
devices (``parallel/spatial.py``), in eval (``cli.eval --spatial``, a copy
of the encoder per band's device) and in training (``cli.train
TPU.spatial``, the one encoder for every band), through the same modules:
each conv (depthwise and dilated ones included) with its halo rows, BN
(over the whole map in training), ReLU6 and the residual add per band. It
returns the deep-supervision map (after block 14) and the last one.

Keys are the reference's: ``features.0.{0,1}`` for the stem, then
``features.{i}.conv.{k}`` with the block's Sequential indices (t == 1:
depthwise 0, project 3; otherwise expand 0, depthwise 3, project 6).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from semseg_tpu_torch.parallel.spatial import Bands, run_banded
from .layers import BatchNorm2d, Conv2d, ConvBN, _Act

# (expand_ratio t, channels c, repeats n, stride s)
INVERTED_RESIDUAL_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

DOWN_IDX = (2, 4, 7, 14)


class InvertedResidual(nn.Module):
    """[1x1 expand →] 3x3 depthwise → 1x1 project, as one ``conv``
    Sequential."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, expand_ratio: int,
                 dilation: int = 1):
        super().__init__()
        hidden = round(in_ch * expand_ratio)
        self.use_res = stride == 1 and in_ch == out_ch
        layers = []
        if expand_ratio != 1:
            layers += [Conv2d(in_ch, hidden, 1, bias=False), BatchNorm2d(hidden),
                       _Act("relu6")]
        layers += [
            Conv2d(hidden, hidden, 3, stride=stride, padding=dilation, dilation=dilation,
                   groups=hidden, bias=False),
            BatchNorm2d(hidden), _Act("relu6"),
            Conv2d(hidden, out_ch, 1, bias=False), BatchNorm2d(out_ch),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2Encoder(nn.Module):
    """MobileNetV2 feature trunk with optional output-stride dilation."""

    def __init__(self, dilate_scale: Optional[int] = 8, *,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dilate_scale = dilate_scale
        self.dtype = dtype
        blocks = [ConvBN(3, 32, 3, stride=2, act="relu6")]
        blocks += [InvertedResidual(i, o, s, t, dilation=d)
                   for i, o, s, t, d in self.block_specs(dilate_scale)]
        self.features = nn.Sequential(*blocks)

    @staticmethod
    def block_specs(dilate_scale):
        """Static (in, out, stride, t, dilation) per feature index 1..17."""
        specs = []
        in_ch = 32
        for t, c, n, s in INVERTED_RESIDUAL_SETTING:
            for i in range(n):
                specs.append([in_ch, c, s if i == 0 else 1, t, 1])
                in_ch = c

        def dilate(lo, hi, d):
            for k in range(lo, hi):
                if specs[k][2] == 2:
                    specs[k][2] = 1
                    specs[k][4] = d // 2
                else:
                    specs[k][4] = d

        # Group boundaries at feature indices 7 and 14 (spec indices 6, 13).
        if dilate_scale == 8:
            dilate(6, 13, 2)
            dilate(13, len(specs), 4)
        elif dilate_scale == 16:
            dilate(13, len(specs), 2)
        return [tuple(s) for s in specs]

    def forward(self, x):
        x = self.features[0](x.to(self.dtype))
        features = []
        for idx in range(1, len(self.features)):
            x = self.features[idx](x)
            if idx in DOWN_IDX:
                features.append(x)
        features.append(x)
        return features


def mobilenetv2dilated(**kw):
    return MobileNetV2Encoder(dilate_scale=8, **kw)


def banded_features(encoders: Sequence[MobileNetV2Encoder], x: Bands):
    """The last two feature maps of ``MobileNetV2Encoder.forward`` (after
    block ``DOWN_IDX[-1]`` and the last block) over an image in row bands;
    ``encoders[j]`` is band j's copy, or ``[encoder]`` the one encoder of
    every band. Output stride 8 only (a band plan cuts strides 1-8)."""
    x = x.map(lambda p: p.to(encoders[0].dtype))
    conv4 = None
    for idx, blocks in enumerate(zip(*(e.features for e in encoders))):
        if isinstance(blocks[0], InvertedResidual):
            out = run_banded([b.conv for b in blocks], x)
            x = x.zip(out, torch.add) if blocks[0].use_res else out
        else:  # the stem's ConvBN
            x = run_banded(blocks, x)
        if idx == DOWN_IDX[-1]:
            conv4 = x
    return conv4, x
