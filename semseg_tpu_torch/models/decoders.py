"""Decoder zoo (``semseg_tpu/models/decoders.py``), NCHW: C1, C1DeepSup,
PPM, PPMDeepsup and UPerNet.

With ``seg_size=(H, W)`` the logits are cast to float32, resized bilinearly
to ``seg_size`` and turned into softmax probabilities, as the reference's
``segSize`` protocol does. With ``seg_size=None`` they come back as float32
logits at decoder resolution (the bucketed engines' call, and the training
forward). A deep-supervision decoder in training mode (``.train()``, the
JAX package's ``train=True``) returns the pair ``(logits,
logits_deepsup)``, both float32; its branch runs off conv4 (with
``Dropout2d(0.1)`` in PPMDeepsup, none in C1DeepSup). Batch norm and
dropout follow their own modules' modes, so under ``TRAIN.fix_bn`` (BN and
dropout in eval, ``SegmentationModel.train``) the deep-supervision branch
still runs: the JAX package's ``train`` / ``norm_train`` split. The four
pyramid pools of PPM and UPerNet run in one call of the hand-written kernel
``ops.kernels.pyramid_pool`` on the NHWC view of conv5; its dense form has
a hand-written backward, so training gets the pools' gradient.

``valid_hw`` (per feature map, (N, 2) int32: each sample's true extent
inside a padded bucket canvas) makes the pyramid branches pad-aware, as
``_PPMPool`` is in the JAX package: the pools bin over the valid region
only and each pooled grid is upsampled back onto that region, zero beyond
it, so the global pools never ingest the canvas padding. C1 and C1DeepSup
have no global op and ignore it; UPerNet's FPN resizes stay full-canvas, as
in the JAX package.

``banded_logits`` is the eval forward of C1, C1DeepSup, PPM and PPMDeepsup
over a conv5 split in row bands across devices (``cli.eval --spatial``,
``parallel/spatial.py``): the pyramid's bins are summed per band by the
band form of the pool kernel, added on the first band's device and divided
by the bin areas there, the branch convs run on the small grids, each band
upsamples its own rows of them, and the 3x3 convs take their halo rows.
``banded_train_logits`` is their training forward over banded conv4 and
conv5 (``cli.train TPU.spatial``), with the one decoder for every band:
the pyramid pools through ``pyramid_pool_bands`` (the band form over the
whole map, differentiable through the band backward kernel), the branch
conv-BN-ReLU runs once on the small grids on the first band's device, each
band computes its rows of the grids' bilinear upsample to the whole map
(``resize_bilinear_rows``: the unsplit forward's ``resize_bilinear`` rows
to rounding, from the grid rows they read), and the deep-supervision head
runs banded over conv4, after the trunk, so that dropout draws its masks in
the unsplit order. UPerNet's cross-resolution
resizes have no banded form yet (ROADMAP item 17c).

Slot names follow the reference: ``cbr`` and ``cbr_deepsup`` are
``conv3x3_bn_relu`` Sequentials; PPM's ``ppm.{i}`` is ``Sequential(pool,
conv, BN, ReLU)`` and its ``conv_last`` ``Sequential(conv, BN, ReLU,
Dropout2d, conv)``; UPerNet's ``ppm_conv.{i}``, ``fpn_in.{i}``,
``fpn_out.{i}.0`` and ``conv_last = Sequential(conv3x3_bn_relu, conv)``.
Inference never runs the deep-supervision parameters; they exist in every
mode so that checkpoints load strict.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from semseg_tpu_torch.ops.dtypes import acc_dtype
from semseg_tpu_torch.ops.kernels.ppm_pool import (
    SCALES,
    band_sums_to_grids,
    pyramid_pool,
    pyramid_pool_band,
    pyramid_pool_bands,
)
from semseg_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_rows
from semseg_tpu_torch.ops.resize_dynamic import upsample_grid_valid
from semseg_tpu_torch.parallel.spatial import Bands, band_apply, band_conv, run_banded
from .layers import BatchNorm2d, Conv2d, ConvBN, Dropout2d, _Act


def _finish(x, seg_size):
    """Inference epilogue: upsample logits to label size, softmax, f32."""
    x = resize_bilinear(x.to(acc_dtype(x.dtype)), seg_size)
    return torch.softmax(x, dim=1)


def _out(x, seg_size):
    """Probabilities at ``seg_size``, or f32 logits at decoder resolution."""
    if seg_size is not None:
        return _finish(x, seg_size)
    return x.to(acc_dtype(x.dtype))


def _onto_map(y, hw, valid):
    """Bilinear-upsample an NCHW pooled grid ``y`` to the map size ``hw``:
    over the whole map, or with ``valid`` onto each sample's valid region,
    zero beyond it."""
    if valid is None:
        return resize_bilinear(y, hw)
    return upsample_grid_valid(y.permute(0, 2, 3, 1), hw, valid).permute(0, 3, 1, 2)


def _with_deepsup(module, x, conv4, seg_size, valid_hw):
    """``x`` as ``_out`` gives it, paired in training with the
    deep-supervision logits of ``conv4`` (``module.cbr_deepsup`` →
    ``dropout_deepsup`` where the decoder has one → ``conv_last_deepsup``)."""
    if not module.training or seg_size is not None or valid_hw is not None:
        return _out(x, seg_size)
    ds = module.cbr_deepsup(conv4)
    if hasattr(module, "dropout_deepsup"):
        ds = module.dropout_deepsup(ds)
    ds = module.conv_last_deepsup(ds)
    return _out(x, None), ds.to(acc_dtype(ds.dtype))


def _pyramid_grids(conv5, valid):
    """The four pyramid grids of NCHW ``conv5``, NCHW views, in one kernel
    call (over each sample's valid region with ``valid``)."""
    pooled = pyramid_pool(conv5.permute(0, 2, 3, 1), SCALES, valid_hw=valid)
    return [p.permute(0, 3, 1, 2) for p in pooled]


class C1(nn.Module):
    """Single conv head (reference models.py:363-385)."""

    def __init__(self, num_class: int = 150, fc_dim: int = 2048):
        super().__init__()
        self.cbr = ConvBN(fc_dim, fc_dim // 4, 3)
        self.conv_last = Conv2d(fc_dim // 4, num_class, 1)

    def forward(self, conv_out, seg_size=None, valid_hw=None):
        del valid_hw  # no global ops: padding only bleeds conv-locally
        return _out(self.conv_last(self.cbr(conv_out[-1])), seg_size)


class C1DeepSup(C1):
    """C1 with the deep-supervision branch off conv4, no dropout
    (models.py:327-359)."""

    def __init__(self, num_class: int = 150, fc_dim: int = 2048):
        super().__init__(num_class, fc_dim)
        self.cbr_deepsup = ConvBN(fc_dim // 2, fc_dim // 4, 3)
        self.conv_last_deepsup = Conv2d(fc_dim // 4, num_class, 1)

    def forward(self, conv_out, seg_size=None, valid_hw=None):
        x = self.conv_last(self.cbr(conv_out[-1]))
        return _with_deepsup(self, x, conv_out[-2], seg_size, valid_hw)


class PPM(nn.Module):
    """Pyramid pooling head (reference models.py:389-434): pool → 1x1
    conv-BN-ReLU → upsample, per grid."""

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

    def _trunk(self, conv_out, valid_hw):
        conv5 = conv_out[-1]
        valid = None if valid_hw is None else valid_hw[-1]
        pyramid = [conv5] + [_onto_map(branch[1:](p), conv5.shape[2:], valid)
                             for branch, p in zip(self.ppm, _pyramid_grids(conv5, valid))]
        return self.conv_last(torch.cat(pyramid, dim=1))

    def forward(self, conv_out, seg_size=None, valid_hw=None):
        return _out(self._trunk(conv_out, valid_hw), seg_size)


class PPMDeepsup(PPM):
    """PPM with the deep-supervision branch off conv4 (models.py:438-495)."""

    def __init__(self, num_class: int = 150, fc_dim: int = 4096):
        super().__init__(num_class, fc_dim)
        self.cbr_deepsup = ConvBN(fc_dim // 2, fc_dim // 4, 3)
        self.dropout_deepsup = Dropout2d(0.1)
        self.conv_last_deepsup = Conv2d(fc_dim // 4, num_class, 1)

    def forward(self, conv_out, seg_size=None, valid_hw=None):
        x = self._trunk(conv_out, valid_hw)
        return _with_deepsup(self, x, conv_out[-2], seg_size, valid_hw)


class UPerNet(nn.Module):
    """UPerNet: PPM on conv5 + top-down FPN fusion (models.py:499-586).

    The PPM branch order here is pool → **upsample** → 1x1 conv-BN-ReLU,
    unlike the PPM decoder; the fused map stays at the finest FPN level.
    """

    def __init__(self, num_class: int = 150, fc_dim: int = 4096,
                 fpn_inplanes: Sequence[int] = (256, 512, 1024, 2048), fpn_dim: int = 256):
        super().__init__()
        self.fpn_inplanes = tuple(fpn_inplanes)
        self.ppm_conv = nn.ModuleList(ConvBN(fc_dim, 512, 1) for _ in SCALES)
        self.ppm_last_conv = ConvBN(fc_dim + len(SCALES) * 512, fpn_dim, 3)
        self.fpn_in = nn.ModuleList(ConvBN(c, fpn_dim, 1) for c in self.fpn_inplanes[:-1])
        self.fpn_out = nn.ModuleList(
            nn.Sequential(ConvBN(fpn_dim, fpn_dim, 3)) for _ in self.fpn_inplanes[:-1]
        )
        self.conv_last = nn.Sequential(
            ConvBN(len(self.fpn_inplanes) * fpn_dim, fpn_dim, 3),
            Conv2d(fpn_dim, num_class, 1),
        )

    def forward(self, conv_out, seg_size=None, valid_hw=None):
        got = tuple(int(c.shape[1]) for c in conv_out)
        if got != self.fpn_inplanes:
            raise ValueError(
                f"UPerNet(fpn_inplanes={self.fpn_inplanes}) fed a {got}-channel "
                "feature pyramid — encoder/decoder mismatch"
            )
        conv5 = conv_out[-1]
        valid = None if valid_hw is None else valid_hw[-1]
        pyramid = [conv5] + [conv(_onto_map(p, conv5.shape[2:], valid))
                             for conv, p in zip(self.ppm_conv, _pyramid_grids(conv5, valid))]
        f = self.ppm_last_conv(torch.cat(pyramid, dim=1))

        # Top-down FPN; its resizes stay full-canvas, as in the JAX package.
        fpn_features = [f]
        for i in reversed(range(len(conv_out) - 1)):
            lateral = self.fpn_in[i](conv_out[i])
            f = lateral + resize_bilinear(f, lateral.shape[2:])
            fpn_features.append(self.fpn_out[i](f))
        fpn_features.reverse()  # [P2 .. P5]

        out_hw = fpn_features[0].shape[2:]
        fusion = [fpn_features[0]] + [resize_bilinear(p, out_hw) for p in fpn_features[1:]]
        return _out(self.conv_last(torch.cat(fusion, dim=1)), seg_size)


def _banded_ppm_trunk(decoders: Sequence[PPM], conv5: Bands, valid) -> Bands:
    """``PPM._trunk`` with ``valid_hw`` over a banded conv5: ``valid[j]`` is
    the (N, 2) extents on band j's device."""
    dev0 = conv5.parts[0].device
    hw = (conv5.height, conv5.parts[0].shape[3])
    total = None
    for part, v, (r0, _) in zip(conv5.parts, valid, conv5.rows):
        sums = pyramid_pool_band(part.permute(0, 2, 3, 1).contiguous(), v, r0, hw[0])
        sums = sums.to(dev0, non_blocking=True)
        total = sums if total is None else total + sums
    grids = band_sums_to_grids(total, valid[0], hw, conv5.parts[0].dtype)
    branches = [branch[1:](g.permute(0, 3, 1, 2))
                for branch, g in zip(decoders[0].ppm, grids)]
    parts = []
    for part, v, rows in zip(conv5.parts, valid, conv5.rows):
        ups = [upsample_grid_valid(y.to(part.device, non_blocking=True).permute(0, 2, 3, 1),
                                   hw, v, rows).permute(0, 3, 1, 2) for y in branches]
        parts.append(torch.cat([part] + ups, dim=1))
    return run_banded([d.conv_last for d in decoders], Bands(parts, conv5.plan, conv5.stride))


def banded_logits(decoders, conv5: Bands, valid) -> Bands:
    """f32 logits at decoder resolution (the eval forward with ``valid_hw``)
    over a banded conv5; ``decoders[j]`` is band j's copy of the decoder and
    ``valid[j]`` the (N, 2) int32 extents of conv5 on band j's device."""
    d = decoders[0]
    if isinstance(d, PPM):
        x = _banded_ppm_trunk(decoders, conv5, valid)
    elif isinstance(d, C1):
        x = run_banded([m.cbr for m in decoders], conv5)
        x = run_banded([m.conv_last for m in decoders], x)
    else:  # UPerNet's cross-resolution resizes have no banded form yet
        raise NotImplementedError(f"banded {type(d).__name__} (ROADMAP item 17c)")
    return x.map(lambda p: p.to(acc_dtype(p.dtype)))


def _banded_ppm_train_trunk(d: PPM, conv5: Bands) -> Bands:
    """``PPM._trunk`` (training, whole-map pools) over a banded conv5."""
    hw = (conv5.height, conv5.parts[0].shape[3])
    grids = pyramid_pool_bands([p.permute(0, 2, 3, 1).contiguous() for p in conv5.parts])
    branches = [branch[1:](g.permute(0, 3, 1, 2)) for branch, g in zip(d.ppm, grids)]
    parts = []
    for part, (r0, r1) in zip(conv5.parts, conv5.rows):
        ups = [resize_bilinear_rows(y.to(part.device, non_blocking=True), hw, (r0, r1))
               for y in branches]
        parts.append(torch.cat([part] + ups, dim=1))
    return run_banded([d.conv_last], Bands(parts, conv5.plan, conv5.stride))


def banded_train_logits(d, conv4: Bands, conv5: Bands):
    """The training forward of C1, C1DeepSup, PPM or PPMDeepsup ``d`` over
    banded conv4 and conv5 (see the module docstring): f32 logits at
    decoder resolution as ``Bands``, and the deep-supervision logits where
    ``d`` has them and is in training mode (else None)."""
    if isinstance(d, PPM):
        x = _banded_ppm_train_trunk(d, conv5)
    elif isinstance(d, C1):
        x = run_banded([d.conv_last], run_banded([d.cbr], conv5))
    else:  # UPerNet's cross-resolution resizes have no banded form yet
        raise NotImplementedError(f"banded {type(d).__name__} (ROADMAP item 17c)")
    logits = x.map(lambda p: p.to(acc_dtype(p.dtype)))
    if not (d.training and hasattr(d, "cbr_deepsup")):
        return logits, None
    ds = run_banded([d.cbr_deepsup], conv4)
    if hasattr(d, "dropout_deepsup"):
        ds = band_apply([d.dropout_deepsup], ds)
    ds = band_conv([d.conv_last_deepsup], ds)
    return logits, ds.map(lambda p: p.to(acc_dtype(p.dtype)))
