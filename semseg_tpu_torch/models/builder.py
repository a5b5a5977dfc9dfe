"""ModelBuilder: architecture keys → modules (``semseg_tpu/models/builder.py``).

The port builds resnet50dilated + ppm_deepsup so far; any other key raises
``NotImplementedError``. Seeded initialisation follows the JAX package's
scheme from an explicit ``torch.Generator``: encoder convs normal with
std ``sqrt(2 / fan_out)``; decoder convs normal with std
``sqrt(2 / fan_in)``, decoder BN bias 1e-4, classifier biases 0.

A built module is in eval mode, in ``torch.channels_last`` and on
``device``; ``weights`` loads a reference-format ``.pth`` strictly.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from . import decoders as dec
from .convert import load_reference_pth
from .resnet import resnet50
from .segmentation import SegmentationModel


def _init(module: nn.Module, generator: torch.Generator, *, mode: str,
          bn_bias: float) -> None:
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            o, i, kh, kw = m.weight.shape
            fan = (o if mode == "fan_out" else i) * kh * kw
            with torch.no_grad():
                m.weight.normal_(0.0, math.sqrt(2.0 / fan), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.fill_(bn_bias)


def _finish(module: nn.Module, weights: str, device) -> nn.Module:
    if weights:
        module.load_state_dict(load_reference_pth(weights), strict=True)
    return module.eval().to(device=device, memory_format=torch.channels_last)


class ModelBuilder:
    @staticmethod
    def build_encoder(arch: str = "resnet50dilated", fc_dim: int = 512,
                      weights: str = "", *, dtype: torch.dtype = torch.float32,
                      device="cpu", generator: torch.Generator | None = None):
        """Build an encoder by architecture key (reference models.py:63-110)."""
        if arch.lower() != "resnet50dilated":
            raise NotImplementedError(f"encoder {arch!r} is not ported yet")
        encoder = resnet50(dilate_scale=8, dtype=dtype)
        _init(encoder, generator or torch.Generator().manual_seed(0),
              mode="fan_out", bn_bias=0.0)
        return _finish(encoder, weights, device)

    @staticmethod
    def build_decoder(arch: str = "ppm_deepsup", fc_dim: int = 512,
                      num_class: int = 150, weights: str = "",
                      use_softmax: bool = False, *, device="cpu",
                      generator: torch.Generator | None = None):
        """Build a decoder by architecture key (reference models.py:112-157).

        ``use_softmax`` is accepted for the reference's signature; the
        inference mode is chosen per call by ``seg_size``.
        """
        if arch.lower() != "ppm_deepsup":
            raise NotImplementedError(f"decoder {arch!r} is not ported yet")
        decoder = dec.PPMDeepsup(num_class=num_class, fc_dim=fc_dim)
        _init(decoder, generator or torch.Generator().manual_seed(1),
              mode="fan_in", bn_bias=1e-4)
        return _finish(decoder, weights, device)

    @staticmethod
    def build_model(cfg, *, dtype: torch.dtype | None = None, device="cpu",
                    seed: int = 0) -> SegmentationModel:
        """The full model from a config node, weights from cfg.MODEL."""
        if dtype is None:
            dtype = getattr(torch, cfg.TPU.compute_dtype)
        generator = torch.Generator().manual_seed(seed)
        encoder = ModelBuilder.build_encoder(
            cfg.MODEL.arch_encoder, cfg.MODEL.fc_dim,
            weights=cfg.MODEL.weights_encoder, dtype=dtype, device=device,
            generator=generator,
        )
        decoder = ModelBuilder.build_decoder(
            cfg.MODEL.arch_decoder, fc_dim=cfg.MODEL.fc_dim,
            num_class=cfg.DATASET.num_class, weights=cfg.MODEL.weights_decoder,
            device=device, generator=generator,
        )
        return SegmentationModel(encoder, decoder)
