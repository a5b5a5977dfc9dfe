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

``set_process_group(model, group)`` makes the training forward that of
one rank of a data-parallel run over ``group``, each rank with its slice of
the global batch: batch norm takes the global batch's statistics, dropout
the global batch's masks, and the loss and accuracy are the global batch's
(JAX's mean over the global batch under GSPMD, not a mean of per-rank
means, which differ whenever the ranks hold different numbers of valid
pixels). One all-reduce brings every rank the loss's sums; the returned
loss has the global value and the gradient of this rank's share
``sum_rank / max(valid_global, 1)``, so the ranks' gradients sum to the
global loss's.

``model(img, seg_label=label, spatial=devices)`` is the training forward
with each image's height split in row bands over ``devices``
(``cli.train TPU.spatial``, the JAX package's hybrid data x spatial mesh):
``parallel.spatial.BandPlan`` cuts the canvas at the encoder's coarsest
stride (``band_base``), the image's rows and the labels' rows (at the
logits' stride) go to their bands' devices, the banded encoder and
decoder run with this one model's parameters (``banded_features``,
``decoders.banded_train_logits``), and each band's loss and accuracy sums
against its label rows are added on the first band's device before the
group's all-reduce, so the loss is the unsplit forward's. Every encoder
and decoder of ``ModelBuilder`` trains banded; with ``TPU.remat`` each
ResNet/ResNeXt block is checkpointed over all its bands
(``resnet.banded_block``), as JAX's ``nn.remat`` runs under its hybrid
mesh, while the decoder (the pyramid pool included), deep supervision and
the loss stay outside any checkpoint.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from semseg_tpu_torch.ops.losses import (
    masked_mean,
    pixel_accuracy_sums,
    softmax_cross_entropy_sums,
)
from semseg_tpu_torch.ops.norm import all_reduce_sum, ordered_collectives
from semseg_tpu_torch.parallel.spatial import BandPlan, split_labels, split_rows
from . import decoders, hrnet, mobilenet, resnet
from .layers import BatchNorm2d, Dropout2d


def map_extents(valid_hw, img_hw, map_hw):
    """(N, 2) extents of a map of ``map_hw``: ``ceil(valid / stride)`` with
    the map's stride taken from the padded image and map shapes."""
    sh, sw = img_hw[0] // map_hw[0], img_hw[1] // map_hw[1]
    return torch.stack([
        (valid_hw[:, 0] + sh - 1) // sh,
        (valid_hw[:, 1] + sw - 1) // sw,
    ], dim=-1).to(torch.int32).contiguous()


def feature_extents(valid_hw, img_hw, feats):
    """Per-feature-map (N, 2) extents (``map_extents``)."""
    return [map_extents(valid_hw, img_hw, f.shape[2:]) for f in feats]


_BANDED_ENCODERS = {resnet.ResNetEncoder: resnet, mobilenet.MobileNetV2Encoder: mobilenet,
                    hrnet.HRNetV2: hrnet}


def check_banded(model: "SegmentationModel") -> None:
    """Raises ``NotImplementedError`` unless ``model`` has banded forwards
    (``banded_logits`` and the ``spatial`` training forward): an encoder
    and a decoder of ``ModelBuilder`` (ResNet/ResNeXt of any output
    stride, MobileNetV2, HRNetV2; C1, PPM, UPerNet and their forms)."""
    enc, dec = model.encoder, model.decoder
    if type(enc) not in _BANDED_ENCODERS or not isinstance(
            dec, (decoders.C1, decoders.PPM, decoders.UPerNet)):
        raise NotImplementedError(f"{type(enc).__name__} + {type(dec).__name__} has no "
                                  "banded form (not a pair ModelBuilder builds)")


def band_base(model: "SegmentationModel") -> int:
    """The coarsest stride of ``model``'s encoder, at which a band plan is
    cut (``parallel.spatial.BandPlan``'s ``base``): the output stride of a
    ResNet/ResNeXt or MobileNetV2 (8 when dilated, else 32), 32 for
    HRNetV2 (its fourth branch)."""
    enc = model.encoder
    if isinstance(enc, hrnet.HRNetV2):
        return 32
    return enc.dilate_scale or 32


def _banded_features(encoders, x):
    return _BANDED_ENCODERS[type(encoders[0])].banded_features(encoders, x)


def banded_logits(models, x, valid_hw, img_hw):
    """f32 logits at decoder resolution of ``model(img, valid_hw=...)``
    (eval) over an image split in row bands (``parallel.spatial.Bands`` of
    the normalised NCHW image, cut at ``band_base``): ``models[j]`` is band
    j's copy of the model and ``valid_hw[j]`` the (N, 2) int32 extents on
    its device; ``img_hw`` the padded image's (H, W). Returns the logits as
    ``Bands``."""
    check_banded(models[0])
    feats = _banded_features([m.encoder for m in models], x)
    conv5 = feats[-1]
    map_hw = (conv5.height, conv5.width)
    valid = [map_extents(v, img_hw, map_hw) for v in valid_hw]
    return decoders.banded_logits([m.decoder for m in models], feats, valid)


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
        self.process_group = None

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.fix_bn:
            for m in self.modules():
                if isinstance(m, (BatchNorm2d, Dropout2d)):
                    m.eval()
        return self

    def forward(self, img, seg_size=None, valid_hw=None, *, seg_label=None, spatial=None):
        if spatial is not None:
            if seg_label is None:
                raise ValueError("spatial: the banded forward of a model is the training "
                                 "forward (seg_label); eval splits through banded_logits")
            return self._banded_loss(img, seg_label, spatial)
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
        terms = [(logits, 1.0)]
        if logits_deepsup is not None and self.deep_sup_scale is not None:
            terms.append((logits_deepsup, self.deep_sup_scale))
        sums = [softmax_cross_entropy_sums(t, seg_label, ignore_index=self.ignore_index)
                for t, _ in terms]
        correct, valid = pixel_accuracy_sums(logits, seg_label, ignore_index=self.ignore_index)
        return self._global_loss(sums, [scale for _, scale in terms], correct, valid)

    def _banded_loss(self, img, seg_label, spatial):
        """The training forward over ``spatial`` devices (module docstring)."""
        check_banded(self)
        plan = BandPlan(img.shape[2], len(spatial), band_base(self))
        devices = list(spatial)[:plan.count]
        with ordered_collectives():  # BN's all-reduces, over bands on several cards
            feats = _banded_features([self.encoder], split_rows(img, plan, devices))
            logits, deepsup = decoders.banded_train_logits(self.decoder, feats)
        labels = split_labels(seg_label, plan, devices, logits.stride)
        terms = [(logits, 1.0)]
        if deepsup is not None and self.deep_sup_scale is not None:
            terms.append((deepsup, self.deep_sup_scale))
        dev0 = devices[0]

        def summed(fn, x):  # the bands' (numerator, denominator) added on dev0
            pairs = [fn(p, lab, ignore_index=self.ignore_index)
                     for p, lab in zip(x.parts, labels)]
            return tuple(sum(v.to(dev0, non_blocking=True) for v in vs) for vs in zip(*pairs))

        sums = [summed(softmax_cross_entropy_sums, t) for t, _ in terms]
        correct, valid = summed(pixel_accuracy_sums, logits)
        return self._global_loss(sums, [scale for _, scale in terms], correct, valid)

    def _global_loss(self, sums, scales, correct, valid):
        """(loss, accuracy) from this rank's (loss sum, valid pixels) per
        term and its accuracy counts: the global value, with the gradient
        of this rank's share (module docstring)."""
        flat = torch.stack([v.detach() for pair in sums for v in pair] + [correct, valid])
        totals = all_reduce_sum(flat, self.process_group)
        share = glob = 0.0
        for k, scale in enumerate(scales):
            share = share + scale * masked_mean(sums[k][0], totals[2 * k + 1])
            glob = glob + scale * masked_mean(totals[2 * k], totals[2 * k + 1])
        # The global value, with the gradient of this rank's share.
        loss = glob + (share - share.detach())
        return loss, totals[-2] / (totals[-1] + 1e-10)


def set_process_group(model: nn.Module, group) -> None:
    """Make ``model``'s training forward a data-parallel rank's over the
    ranks of ``group`` (module docstring); ``None`` makes it one process's."""
    for m in model.modules():
        if isinstance(m, (BatchNorm2d, Dropout2d, SegmentationModel)):
            m.process_group = group
