"""Deep-stem ResNet / ResNeXt encoders (``semseg_tpu/models/resnet.py``), NCHW.

* deep 3-conv stem: 3x3/s2 3→64, 3x3 64→64, 3x3 64→128, then max pool
  3/2/1; ``inplanes`` starts at 128;
* BasicBlock (expansion 1), Bottleneck (expansion 4) and GroupBottleneck
  (ResNeXt: expansion 2, grouped 3x3 conv);
* output stride 8 or 16 by construction-time dilation: in a stage dilated
  by ``d`` the first block keeps stride 1 and its formerly strided 3x3 conv
  gets dilation ``max(d // 2, 1)``, every other 3x3 conv of the stage gets
  ``d``; without ``dilate_scale`` the encoder has output stride 32.

With ``remat`` (``TPU.remat``; the JAX package wraps each ``ResBlock`` in
``nn.remat``) every residual block of a training forward runs under
``torch.utils.checkpoint``: its activations are dropped after the forward
and recomputed in the backward, for less activation memory at the cost of
a second forward through the blocks. Eval is unchanged. BN's running
statistics advance once per forward (``layers.recomputing``).

``banded_features`` is the forward of an image split in row bands across
devices (``parallel/spatial.py``), in eval (``cli.eval --spatial``, with
one copy of the encoder per band's device) and in training (``cli.train
TPU.spatial``, the one encoder for every band): the same modules'
parameters, each conv with its halo rows, BN (over the whole map in
training), ReLU and the residual add per band. It returns conv4 and conv5,
which the deep-supervision decoders read. Remat has no banded form yet.

Attribute names are the reference's (``conv1``, ``bn1``, ``layer3.0.conv2``,
``layer3.0.downsample.0``), so its checkpoints load as they are. The encoder
returns the four stage outputs ``[c2, c3, c4, c5]``.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from semseg_tpu_torch.ops.pool import max_pool2d
from semseg_tpu_torch.parallel.spatial import (
    Bands,
    band_apply,
    band_conv,
    band_max_pool,
    run_banded,
)
from .layers import BatchNorm2d, Conv2d, ConvBN, recomputing

EXPANSION = {"basic": 1, "bottleneck": 4, "group_bottleneck": 2}


class ResBlock(nn.Module):
    """One residual block: basic (3x3 → 3x3), or bottleneck / grouped
    bottleneck (1x1 → 3x3 (stride, dilation, groups) → 1x1).

    ``first_dilation`` is the dilation of the (formerly) strided 3x3 conv,
    ``dilation`` that of a basic block's second 3x3 conv.
    """

    def __init__(self, block: str, inplanes: int, planes: int, *, stride: int = 1,
                 dilation: int = 1, first_dilation: int = 1, groups: int = 1,
                 has_downsample: bool = False, remat: bool = False):
        super().__init__()
        self.remat = remat
        out_ch = planes * EXPANSION[block]
        self.basic = block == "basic"
        if self.basic:
            self.conv1 = Conv2d(inplanes, planes, 3, stride=stride, padding=first_dilation,
                                dilation=first_dilation, bias=False)
            self.bn1 = BatchNorm2d(planes)
            self.conv2 = Conv2d(planes, planes, 3, padding=dilation, dilation=dilation,
                                bias=False)
            self.bn2 = BatchNorm2d(planes)
        else:
            self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
            self.bn1 = BatchNorm2d(planes)
            self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=first_dilation,
                                dilation=first_dilation, groups=groups, bias=False)
            self.bn2 = BatchNorm2d(planes)
            self.conv3 = Conv2d(planes, out_ch, 1, bias=False)
            self.bn3 = BatchNorm2d(out_ch)
        self.downsample = (
            ConvBN(inplanes, out_ch, 1, stride=stride, act=None)
            if has_downsample else None
        )

    def forward(self, x):
        if self.remat and self.training and torch.is_grad_enabled():
            # The block has no random op, so no RNG state is kept for the
            # recompute.
            return checkpoint(self._forward, x, use_reentrant=False, preserve_rng_state=False,
                              context_fn=lambda: (contextlib.nullcontext(), recomputing()))
        return self._forward(x)

    def _forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        if self.basic:
            out = self.bn2(self.conv2(out))
        else:
            out = F.relu(self.bn2(self.conv2(out)))
            out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNetEncoder(nn.Module):
    """Deep-stem ResNet/ResNeXt with optional output-stride dilation."""

    def __init__(self, block: str = "bottleneck", layers: Sequence[int] = (3, 4, 6, 3),
                 planes: Sequence[int] = (64, 128, 256, 512), *, groups: int = 1,
                 dilate_scale: Optional[int] = None, remat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dilate_scale = dilate_scale
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 3, stride=2, padding=1, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = Conv2d(64, 64, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(64)
        self.conv3 = Conv2d(64, 128, 3, padding=1, bias=False)
        self.bn3 = BatchNorm2d(128)

        strides, dilations = self.stage_dilations()
        inplanes = 128
        for i, (blocks, width) in enumerate(zip(layers, planes)):
            stride, d = strides[i], dilations[i]
            out_ch = width * EXPANSION[block]
            stage = []
            for j in range(blocks):
                first = j == 0
                stage.append(ResBlock(
                    block, inplanes if first else out_ch, width,
                    stride=stride if first else 1,
                    # The formerly strided conv gets d // 2; all other 3x3
                    # convs of the stage get d.
                    first_dilation=max(d // 2, 1) if first else d,
                    dilation=d, groups=groups,
                    has_downsample=first and (stride != 1 or inplanes != out_ch),
                    remat=remat,
                ))
            inplanes = out_ch
            self.add_module(f"layer{i + 1}", nn.Sequential(*stage))

    def stage_dilations(self):
        """Per-stage (stride, dilation) after the reference's surgery."""
        strides = [1, 2, 2, 2]
        dilations = [1, 1, 1, 1]
        if self.dilate_scale == 8:
            strides[2:] = [1, 1]
            dilations[2:] = [2, 4]
        elif self.dilate_scale == 16:
            strides[3] = 1
            dilations[3] = 2
        return strides, dilations

    def forward(self, x):
        x = x.to(self.dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = max_pool2d(x, kernel_size=3, stride=2, padding=1)
        features = []
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
            features.append(x)
        return features


def _banded_block(blocks: Sequence[ResBlock], x: Bands) -> Bands:
    """``ResBlock._forward`` over a banded map (``blocks[j]``: band j's copy)."""
    def each(name):
        return [getattr(b, name) for b in blocks]

    out = band_apply(each("bn1"), band_conv(each("conv1"), x)).map(F.relu)
    out = band_apply(each("bn2"), band_conv(each("conv2"), out))
    if not blocks[0].basic:
        out = band_apply(each("bn3"), band_conv(each("conv3"), out.map(F.relu)))
    residual = x if blocks[0].downsample is None else run_banded(each("downsample"), x)
    return out.zip(residual, lambda o, r: F.relu(o + r))


def banded_features(encoders: Sequence[ResNetEncoder], x: Bands):
    """(conv4, conv5) of ``ResNetEncoder.forward`` over an image in row
    bands; ``encoders[j]`` is band j's copy of the encoder, or
    ``[encoder]`` the one encoder of every band (module docstring).
    Output stride 8 only (``dilate_scale=8``): a band plan cuts strides
    1-8."""
    enc = encoders[0]
    x = x.map(lambda p: p.to(enc.dtype))
    for i in (1, 2, 3):
        conv = [getattr(e, f"conv{i}") for e in encoders]
        x = band_apply([getattr(e, f"bn{i}") for e in encoders], band_conv(conv, x)).map(F.relu)
    x = band_max_pool(x, kernel_size=3, stride=2, padding=1)
    features = []
    for stage in ("layer1", "layer2", "layer3", "layer4"):
        for blocks in zip(*(getattr(e, stage) for e in encoders)):
            x = _banded_block(blocks, x)
        features.append(x)
    return features[2], features[3]


def resnet18(**kw):
    return ResNetEncoder(block="basic", layers=(2, 2, 2, 2), **kw)


def resnet50(**kw):
    return ResNetEncoder(block="bottleneck", layers=(3, 4, 6, 3), **kw)


def resnet101(**kw):
    return ResNetEncoder(block="bottleneck", layers=(3, 4, 23, 3), **kw)


def resnext101(**kw):
    return ResNetEncoder(block="group_bottleneck", layers=(3, 4, 23, 3),
                         planes=(128, 256, 512, 1024), groups=32, **kw)
