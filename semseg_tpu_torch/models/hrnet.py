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
from .layers import BatchNorm2d, Conv2d, ConvBN
from .resnet import ResBlock

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

    def forward(self, x):
        x = x.to(self.dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for s in (2, 3, 4):
            trans = getattr(self, f"transition{s - 1}")
            # A new branch grows from the lowest-resolution previous one.
            xs = [xs[i] if t is None else t(xs[min(i, len(xs) - 1)])
                  for i, t in enumerate(trans)]
            xs = getattr(self, f"stage{s}")(xs)
        hw = xs[0].shape[2:]
        return [torch.cat([xs[0]] + [resize_bilinear(b, hw) for b in xs[1:]], dim=1)]


def hrnetv2(**kw):
    return HRNetV2(**kw)
