"""HRNetV2-W48 encoder (``semseg_tpu/models/hrnet.py``), NCHW.

* stem: two 3x3/s2 convs to 64 channels, then ``layer1``: 4 Bottleneck
  blocks → 256 channels at 1/4;
* stage 2: 1 module, branches (48, 96); stage 3: 4 modules, (48, 96, 192);
  stage 4: 3 modules, (48, 96, 192, 384); 4 BasicBlocks per branch;
* transitions adapt an existing branch whose width changes (3x3 conv) and
  create each new branch from the previous stage's lowest-resolution one
  through strided 3x3 convs;
* every module ends with full fusion: branch j > i through a 1x1 conv + BN
  and a bilinear upsample, j < i through (i - j) strided 3x3 convs (ReLU on
  all but the last), summed, ReLU;
* output: the four branches upsampled to 1/4 and concatenated, one
  720-channel map (the encoder returns ``[x]``).

``banded_features`` is the forward of an image split in row bands across
devices (``parallel/spatial.py``), in eval (one copy of the encoder per
band's device) and in training (the one encoder for every band): every
conv with its halo rows (the j < i fusions' strided convs too), BN (over
the whole map in training), the j > i fusions' 1x1 conv then
``band_resize`` onto the finer branch's rows, the sum and ReLU per band,
and the four branches resized to stride 4 and concatenated per band. Its
band plan is cut at stride 32, the coarsest branch's.

Keys are the reference's: ``conv1``/``bn1``/``conv2``/``bn2``,
``layer1.{j}``, ``transition{s}.{i}.{0,1}`` (width change) or
``transition{s}.{i}.{j}.{0,1}`` (new branch), ``stage{s}.{m}.branches.{i}.{b}``
and ``stage{s}.{m}.fuse_layers.{i}.{j}[.{k}].{0,1}``; branches that pass
through unchanged hold ``None``, as in the reference's ``ModuleList``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F

from semseg_tpu_torch.ops.resize import resize_bilinear
from semseg_tpu_torch.parallel.spatial import (
    Bands,
    band_apply,
    band_conv,
    band_resize,
    cat_bands,
    run_banded,
)
from .layers import BatchNorm2d, Conv2d, ConvBN
from .resnet import ResBlock, banded_block

#: The momentum of every HRNetV2 batch norm (the reference's hrnet.py:14);
#: the rest of the zoo keeps ``BatchNorm2d``'s 0.001.
BN_MOMENTUM = 0.1
STAGE2 = dict(num_modules=1, num_branches=2, num_blocks=4, channels=(48, 96))
STAGE3 = dict(num_modules=4, num_branches=3, num_blocks=4, channels=(48, 96, 192))
STAGE4 = dict(num_modules=3, num_branches=4, num_blocks=4, channels=(48, 96, 192, 384))


class HRModule(nn.Module):
    """One HighResolutionModule: per-branch BasicBlocks, then full fusion."""

    def __init__(self, channels: Sequence[int], num_blocks: int = 4):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*(ResBlock("basic", c, c) for _ in range(num_blocks)))
            for c in channels
        )
        self.fuse_layers = None
        if n > 1:
            fuse = []
            for i in range(n):
                row = []
                for j in range(n):
                    if j == i:
                        row.append(None)
                    elif j > i:
                        row.append(ConvBN(channels[j], channels[i], 1, act=None))
                    else:
                        row.append(nn.Sequential(*(
                            ConvBN(channels[j], channels[i] if k == i - j - 1 else channels[j],
                                   3, stride=2, act=None if k == i - j - 1 else "relu")
                            for k in range(i - j)
                        )))
                fuse.append(nn.ModuleList(row))
            self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs):
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return xs
        fused = []
        for i, row in enumerate(self.fuse_layers):
            hw = xs[i].shape[2:]
            y = None
            for j, layer in enumerate(row):
                if j == i:
                    t = xs[j]
                elif j > i:
                    t = resize_bilinear(layer(xs[j]), hw)
                else:
                    t = layer(xs[j])
                y = t if y is None else y + t
            fused.append(F.relu(y))
        return fused


class HRNetV2(nn.Module):
    """HRNetV2-W48 trunk; returns a single 720-channel map at 1/4."""

    def __init__(self, *, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 3, stride=2, padding=1, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = Conv2d(64, 64, 3, stride=2, padding=1, bias=False)
        self.bn2 = BatchNorm2d(64)
        self.layer1 = nn.Sequential(*(
            ResBlock("bottleneck", 64 if j == 0 else 256, 64, has_downsample=j == 0)
            for j in range(4)
        ))
        prev = (256,)
        for s, stage in enumerate((STAGE2, STAGE3, STAGE4), start=2):
            channels = stage["channels"]
            trans = []
            for i, ch in enumerate(channels):
                if i < len(prev):
                    trans.append(ConvBN(prev[i], ch, 3) if prev[i] != ch else None)
                else:
                    trans.append(nn.Sequential(*(
                        ConvBN(prev[-1], ch if j == i - len(prev) else prev[-1], 3, stride=2)
                        for j in range(i + 1 - len(prev))
                    )))
            self.add_module(f"transition{s - 1}", nn.ModuleList(trans))
            self.add_module(f"stage{s}", nn.Sequential(*(
                HRModule(channels, stage["num_blocks"]) for _ in range(stage["num_modules"])
            )))
            prev = channels
        for m in self.modules():
            if isinstance(m, BatchNorm2d):
                m.momentum = BN_MOMENTUM

    def forward(self, x):
        x = x.to(self.dtype)
        x = self.bn1(self.conv1(x), act="relu")
        x = self.bn2(self.conv2(x), act="relu")
        xs = [self.layer1(x)]
        for s in (2, 3, 4):
            trans = getattr(self, f"transition{s - 1}")
            # A new branch grows from the lowest-resolution previous one.
            xs = [xs[i] if t is None else t(xs[min(i, len(xs) - 1)])
                  for i, t in enumerate(trans)]
            xs = getattr(self, f"stage{s}")(xs)
        hw = xs[0].shape[2:]
        return [torch.cat([xs[0]] + [resize_bilinear(b, hw) for b in xs[1:]], dim=1)]


def _banded_module(modules: Sequence[HRModule], xs: Sequence[Bands]):
    """``HRModule.forward`` over banded branches (``modules[j]``: band j's
    copy, or ``[module]``)."""
    outs = []
    for i, x in enumerate(xs):
        for blocks in zip(*(m.branches[i] for m in modules)):
            x = banded_block(blocks, x)
        outs.append(x)
    if modules[0].fuse_layers is None:
        return outs
    fused = []
    for i, target in enumerate(outs):
        y = None
        for j, x in enumerate(outs):
            if j != i:
                x = run_banded([m.fuse_layers[i][j] for m in modules], x)
                if j > i:
                    x = band_resize(x, target.stride, target.width)
            y = x if y is None else y.zip(x, torch.add)
        fused.append(y.map(F.relu))
    return fused


def banded_features(encoders: Sequence[HRNetV2], x: Bands):
    """``HRNetV2.forward`` over an image in row bands (module docstring):
    ``[x]``, the 720-channel stride-4 map as ``Bands``; ``encoders[j]`` is
    band j's copy of the encoder, or ``[encoder]`` the one encoder of
    every band. The plan must cut strides up to 32."""
    def each(name):
        return [getattr(e, name) for e in encoders]

    x = x.map(lambda p: p.to(encoders[0].dtype))
    x = band_apply(each("bn1"), band_conv(each("conv1"), x), act="relu")
    x = band_apply(each("bn2"), band_conv(each("conv2"), x), act="relu")
    for blocks in zip(*each("layer1")):
        x = banded_block(blocks, x)
    xs = [x]
    for s in (2, 3, 4):
        trans = each(f"transition{s - 1}")
        xs = [xs[i] if t is None else run_banded([tr[i] for tr in trans],
                                                 xs[min(i, len(xs) - 1)])
              for i, t in enumerate(trans[0])]
        for modules in zip(*each(f"stage{s}")):
            xs = _banded_module(modules, xs)
    first = xs[0]
    return [cat_bands([first] + [band_resize(b, first.stride, first.width)
                                 for b in xs[1:]])]


def hrnetv2(**kw):
    return HRNetV2(**kw)
