"""ModelBuilder: architecture keys → modules (``semseg_tpu/models/builder.py``).

Every key of the JAX builder: encoders ``mobilenetv2dilated``,
``resnet18[dilated]``, ``resnet50[dilated]``, ``resnet101[dilated]``,
``resnext101``, ``hrnetv2`` (``resnet34*`` raises ``NotImplementedError``,
as in JAX); decoders ``c1_deepsup``, ``c1``, ``ppm``, ``ppm_deepsup``,
``upernet`` (``fpn_dim`` 512) and ``upernet_lite`` (256). An unknown key
raises ``ValueError``.

Seeded initialisation follows the JAX package's scheme, the same for every
family, from an explicit ``torch.Generator``: encoder convs normal with std
``sqrt(2 / fan_out)`` and BN bias 0; decoder convs normal with std
``sqrt(2 / fan_in)``, decoder BN bias 1e-4, classifier biases 0.

A built module is in eval mode, in ``torch.channels_last`` and on
``device`` (the card unless the caller asks for another); ``weights`` loads
a reference-format ``.pth`` strictly.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn

from . import decoders as dec
from . import hrnet as hrnet_mod
from . import mobilenet as mobilenet_mod
from . import resnet as resnet_mod
from .convert import load_reference_pth
from .segmentation import SegmentationModel

# Stage output channels per encoder (UPerNet's fpn_inplanes; the
# deep-supervision branch reads conv_out[-2]).
ENCODER_CHANNELS = {
    "mobilenetv2dilated": (24, 32, 64, 160, 320),
    "resnet18": (64, 128, 256, 512),
    "resnet18dilated": (64, 128, 256, 512),
    "resnet50": (256, 512, 1024, 2048),
    "resnet50dilated": (256, 512, 1024, 2048),
    "resnet101": (256, 512, 1024, 2048),
    "resnet101dilated": (256, 512, 1024, 2048),
    "resnext101": (256, 512, 1024, 2048),
    "hrnetv2": (720,),
}


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


_ENCODERS = {
    "mobilenetv2dilated": mobilenet_mod.mobilenetv2dilated,
    "resnet18": resnet_mod.resnet18,
    "resnet18dilated": functools.partial(resnet_mod.resnet18, dilate_scale=8),
    "resnet50": resnet_mod.resnet50,
    "resnet50dilated": functools.partial(resnet_mod.resnet50, dilate_scale=8),
    "resnet101": resnet_mod.resnet101,
    "resnet101dilated": functools.partial(resnet_mod.resnet101, dilate_scale=8),
    "resnext101": resnet_mod.resnext101,
    "hrnetv2": hrnet_mod.hrnetv2,
}


def _encoder(arch: str, dtype: torch.dtype) -> nn.Module:
    if arch in ("resnet34", "resnet34dilated"):
        raise NotImplementedError(arch)
    if arch not in _ENCODERS:
        raise ValueError(f"Architecture undefined: {arch!r}")
    return _ENCODERS[arch](dtype=dtype)


def _decoder(arch: str, fc_dim: int, num_class: int, encoder_arch) -> nn.Module:
    kw = dict(num_class=num_class, fc_dim=fc_dim)
    simple = {"c1_deepsup": dec.C1DeepSup, "c1": dec.C1, "ppm": dec.PPM,
              "ppm_deepsup": dec.PPMDeepsup}
    if arch in simple:
        return simple[arch](**kw)
    if arch in ("upernet", "upernet_lite"):
        fpn_inplanes = ENCODER_CHANNELS.get((encoder_arch or "resnet50").lower(),
                                            (256, 512, 1024, 2048))
        return dec.UPerNet(fpn_inplanes=fpn_inplanes,
                           fpn_dim=512 if arch == "upernet" else 256, **kw)
    raise ValueError(f"Architecture undefined: {arch!r}")


class ModelBuilder:
    @staticmethod
    def build_encoder(arch: str = "resnet50dilated", fc_dim: int = 512,
                      weights: str = "", *, dtype: torch.dtype = torch.float32,
                      device="cuda", generator: torch.Generator | None = None):
        """Build an encoder by architecture key (reference models.py:63-110)."""
        encoder = _encoder(arch.lower(), dtype)
        _init(encoder, generator or torch.Generator().manual_seed(0),
              mode="fan_out", bn_bias=0.0)
        return _finish(encoder, weights, device)

    @staticmethod
    def build_decoder(arch: str = "ppm_deepsup", fc_dim: int = 512,
                      num_class: int = 150, weights: str = "",
                      use_softmax: bool = False, *, encoder_arch: str | None = None,
                      device="cuda", generator: torch.Generator | None = None):
        """Build a decoder by architecture key (reference models.py:112-157).

        ``use_softmax`` is accepted for the reference's signature; the
        inference mode is chosen per call by ``seg_size``. ``encoder_arch``
        gives UPerNet its ``fpn_inplanes``.
        """
        decoder = _decoder(arch.lower(), fc_dim, num_class, encoder_arch)
        _init(decoder, generator or torch.Generator().manual_seed(1),
              mode="fan_in", bn_bias=1e-4)
        return _finish(decoder, weights, device)

    @staticmethod
    def build_model(cfg, *, dtype: torch.dtype | None = None, device="cuda",
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
            encoder_arch=cfg.MODEL.arch_encoder, device=device, generator=generator,
        )
        return SegmentationModel(encoder, decoder)
