"""Deep-stem ResNet / ResNeXt encoders (``semseg_tpu/models/resnet.py``), NCHW.

* deep 3-conv stem: 3x3/s2 3→64, 3x3 64→64, 3x3 64→128, then max pool
  3/2/1; ``inplanes`` starts at 128;
* BasicBlock (expansion 1), Bottleneck (expansion 4) and GroupBottleneck
  (ResNeXt: expansion 2, grouped 3x3 conv);
* output stride 8 or 16 by construction-time dilation: in a stage dilated
  by ``d`` the first block keeps stride 1 and its formerly strided 3x3 conv
  gets dilation ``max(d // 2, 1)``, every other 3x3 conv of the stage gets
  ``d``; without ``dilate_scale`` the encoder has output stride 32.

Each BN is handed what follows it (``layers.BatchNorm2d``'s ``act`` and
``residual``): the stem's and a block's inner BNs their ReLU, a block's
last BN the residual and ReLU, so in eval each is one kernel launch.

With ``remat`` (``TPU.remat``; the JAX package wraps each ``ResBlock`` in
``nn.remat``) every residual block of a training forward runs under
``torch.utils.checkpoint`` (``checkpointed``): its activations are dropped
after the forward and recomputed in the backward, for less activation
memory at the cost of a second forward through the blocks. Eval is
unchanged. BN's running statistics advance once per forward, and the
recompute issues no collective: it replays the totals its forward's BNs
all-reduced (``layers.recomputing``).

``banded_features`` is the forward of an image split in row bands across
devices (``parallel/spatial.py``), in eval (``cli.eval --spatial``, with
one copy of the encoder per band's device) and in training (``cli.train
TPU.spatial``, the one encoder for every band): the same modules'
parameters, each conv with its halo rows, BN (over the whole map in
training), ReLU and the residual add per band. It returns the four stage
maps, as ``forward`` does, at any output stride: the band plan is cut at
the encoder's coarsest stride (``models.segmentation.band_base``), so the
strided convs of layers 2-4 keep every band edge exact. With remat each
banded block of a training forward is one checkpoint over all its bands
(``banded_block``), recomputed once in the backward, on one autograd
thread, when the gradients of all its bands have arrived.

Attribute names are the reference's (``conv1``, ``bn1``, ``layer3.0.conv2``,
``layer3.0.downsample.0``), so its checkpoints load as they are. The encoder
returns the four stage outputs ``[c2, c3, c4, c5]``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from semseg_tpu_torch.ops.norm import keeping
from semseg_tpu_torch.ops.pool import max_pool2d
from semseg_tpu_torch.parallel.spatial import (
    Bands,
    band_apply,
    band_conv,
    band_max_pool,
    run_banded,
)
from .layers import BatchNorm2d, Conv2d, ConvBN, in_recompute, recomputing

EXPANSION = {"basic": 1, "bottleneck": 4, "group_bottleneck": 2}

#: Checkpointed calls recomputed in a backward (``checkpointed``), counted
#: for the tests and ``chip_smoke.py``.
RECOMPUTES = 0


class _RecomputeFirst(torch.autograd.Function):
    """The identity on the outputs of a checkpointed call, saving the first
    under the checkpoint. Its backward is the call's first node (it takes
    every output's gradient, from every band's card) and unpacks that
    tensor, so the whole recompute runs there, on one autograd thread,
    before any other node of the call needs a saved tensor. Over bands on
    several cards autograd runs each card's nodes on a thread of its own,
    and ``torch.utils.checkpoint`` lets no second thread enter a recompute
    that another is running."""

    @staticmethod
    def forward(ctx, *outs):
        ctx.save_for_backward(outs[0])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        ctx.saved_tensors  # noqa: B018 (the unpack recomputes the call)
        return grads


def checkpointed(fn, *args):
    """The tensors ``fn(*args)`` returns (a sequence), computed under a
    non-reentrant activation checkpoint: the tensors it saves for the
    backward are dropped and recomputed there, once, in the
    ``layers.recomputing`` context, as its outputs' gradients all arrive
    (``_RecomputeFirst``). ``fn`` draws no random numbers (no RNG state is
    kept), and its all-reduces are replayed in the recompute, not repeated
    (``ops.norm.keeping``)."""
    kept = []

    def run(*inputs):
        global RECOMPUTES
        if in_recompute():
            RECOMPUTES += 1
        return _RecomputeFirst.apply(*fn(*inputs))

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (keeping(kept), recomputing(kept)))


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

    def takes_checkpoint(self) -> bool:
        """Whether this block's forward runs under a checkpoint now: remat,
        training mode and grad enabled."""
        return self.remat and self.training and torch.is_grad_enabled()

    def forward(self, x):
        if self.takes_checkpoint():
            return checkpointed(lambda t: [self._forward(t)], x)[0]
        return self._forward(x)

    def _forward(self, x):
        out = self.bn1(self.conv1(x), act="relu")
        if self.basic:
            out, last = self.conv2(out), self.bn2
        else:
            out = self.bn2(self.conv2(out), act="relu")
            out, last = self.conv3(out), self.bn3
        residual = x if self.downsample is None else self.downsample(x)
        return last(out, act="relu", residual=residual)


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
        x = self.bn1(self.conv1(x), act="relu")
        x = self.bn2(self.conv2(x), act="relu")
        x = self.bn3(self.conv3(x), act="relu")
        x = max_pool2d(x, kernel_size=3, stride=2, padding=1)
        features = []
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
            features.append(x)
        return features


def banded_block(blocks: Sequence[ResBlock], x: Bands) -> Bands:
    """``ResBlock.forward`` over a banded map (``blocks[j]``: band j's copy,
    or ``[block]`` for every band). A block that takes a checkpoint
    (``ResBlock.takes_checkpoint``) takes one for all the bands: its inputs
    are the band tensors, each on its device, and the recompute re-reads
    the halos and BN's sums over the bands."""
    if not blocks[0].takes_checkpoint():
        return _banded_block(blocks, x)
    stride = []  # the output's (the recompute finds the same)

    def run(*parts):
        out = _banded_block(blocks, Bands(list(parts), x.plan, x.stride))
        stride[:] = [out.stride]
        return out.parts

    return Bands(list(checkpointed(run, *x.parts)), x.plan, stride[0])


def _banded_block(blocks: Sequence[ResBlock], x: Bands) -> Bands:
    def each(name):
        return [getattr(b, name) for b in blocks]

    out = band_apply(each("bn1"), band_conv(each("conv1"), x), act="relu")
    if blocks[0].basic:
        out = band_apply(each("bn2"), band_conv(each("conv2"), out))
    else:
        out = band_apply(each("bn2"), band_conv(each("conv2"), out), act="relu")
        out = band_apply(each("bn3"), band_conv(each("conv3"), out))
    residual = x if blocks[0].downsample is None else run_banded(each("downsample"), x)
    return out.zip(residual, lambda o, r: F.relu(o + r))


def banded_features(encoders: Sequence[ResNetEncoder], x: Bands):
    """The four stage maps of ``ResNetEncoder.forward`` over an image in
    row bands, as ``Bands``; ``encoders[j]`` is band j's copy of the
    encoder, or ``[encoder]`` the one encoder of every band (module
    docstring). The plan must cut strides up to the encoder's output
    stride."""
    enc = encoders[0]
    x = x.map(lambda p: p.to(enc.dtype))
    for i in (1, 2, 3):
        conv = [getattr(e, f"conv{i}") for e in encoders]
        x = band_apply([getattr(e, f"bn{i}") for e in encoders], band_conv(conv, x), act="relu")
    x = band_max_pool(x, kernel_size=3, stride=2, padding=1)
    features = []
    for stage in ("layer1", "layer2", "layer3", "layer4"):
        for blocks in zip(*(getattr(e, stage) for e in encoders)):
            x = banded_block(blocks, x)
        features.append(x)
    return features


def resnet18(**kw):
    return ResNetEncoder(block="basic", layers=(2, 2, 2, 2), **kw)


def resnet50(**kw):
    return ResNetEncoder(block="bottleneck", layers=(3, 4, 6, 3), **kw)


def resnet101(**kw):
    return ResNetEncoder(block="bottleneck", layers=(3, 4, 23, 3), **kw)


def resnext101(**kw):
    return ResNetEncoder(block="group_bottleneck", layers=(3, 4, 23, 3),
                         planes=(128, 256, 512, 1024), groups=32, **kw)
