"""Plain PyTorch reference of the benchmark's two configurations.

ResNet-50 with the deep stem (3x3/s2 3->64, 3x3 64->64, 3x3 64->128, max
pool 3/2/1), Bottleneck blocks (3, 4, 6, 3); "dilated" removes the strides
of layers 3 and 4 and dilates their 3x3 convs as CSAILVision's
``_nostride_dilate`` does (the formerly strided conv by d // 2, the others
by d, d = 2 and 4): output stride 8, else 32. Decoders: PPM with deep
supervision (pool -> 1x1 conv-BN-ReLU -> upsample, per grid 1/2/3/6; 3x3
conv-BN-ReLU, Dropout2d(0.1), 1x1 conv; the deep-supervision head off conv4)
and UPerNet (pool -> upsample -> 1x1 conv-BN-ReLU, top-down FPN of width
``fpn_dim``, fusion at the finest level). Parameter names are the
CSAILVision ``state_dict`` keys, under ``encoder.`` and ``decoder.``.

Everything is a function of the ``params`` dict: no module, no kernel of
the program under test. ``Numerics`` sets the arithmetic: float32 (the
caller turns TF32 off) or float64, and optionally the storage of what the
configuration keeps in bfloat16, in bfloat16 or in float8 (the control of
the correctness check: the precision below the configuration's).
``flops`` counts each convolution's multiply-adds (x2) at the shapes it
ran; on meta tensors that is a count without compute.

Pad-aware evaluation (``valid``: per sample, the (rows, cols) of conv5 that
hold the image): the pyramid pools average over that region only and each
pooled grid is upsampled onto it, zero beyond; everything else runs over
the whole canvas, as the benchmark's protocol defines the packed engine.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

SCALES = (1, 2, 3, 6)
BLOCKS = (3, 4, 6, 3)
PLANES = (64, 128, 256, 512)
FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}  # largest finite values


def _float8(t: torch.Tensor, fmt) -> torch.Tensor:
    """``t`` rounded to a float8 format under one scale for the whole
    tensor (its largest magnitude maps to the format's largest value)."""
    scale = t.abs().amax().clamp(min=1e-30) / FP8[fmt]
    return (t / scale).to(fmt).to(t.dtype) * scale


def _bfloat16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


# Per storage precision: the rounding of a stored value, and of its gradient
# (float8 training's formats: e4m3 values, e5m2 gradients).
LOW = {"bfloat16": (_bfloat16, _bfloat16),
       "float8": (lambda t: _float8(t, torch.float8_e4m3fn),
                  lambda g: _float8(g, torch.float8_e5m2))}


class _Stored(torch.autograd.Function):
    """A tensor stored in a low precision: rounded in the forward, its
    gradient rounded in the backward; the arithmetic around it stays in the
    compute dtype (float32), as a bfloat16 kernel accumulates in float32."""

    @staticmethod
    def forward(ctx, t, low):
        ctx.low = low
        return LOW[low][0](t)

    @staticmethod
    def backward(ctx, grad):
        return LOW[ctx.low][1](grad), None


@dataclass
class Numerics:
    """The reference's arithmetic: ``dtype`` for every computation, and
    with ``low`` every tensor that the configuration keeps in bfloat16
    (convolution operands and outputs, BN's outputs, residual sums, the
    pyramid's grids and resizes, and their gradients) stored in ``low``:
    "bfloat16" emulates the configuration's own precision, "float8" the
    precision below it (the control of the correctness check)."""

    dtype: torch.dtype = torch.float32
    low: Optional[str] = None
    flops: int = 0


@dataclass
class Arch:
    encoder: str  # "resnet50dilated" or "resnet50"
    decoder: str  # "ppm_deepsup" or "upernet"
    fc_dim: int = 2048
    num_class: int = 150
    fpn_dim: int = 512

    @property
    def output_stride(self) -> int:
        """The encoder's stride of conv5."""
        return 8 if self.encoder.endswith("dilated") else 32

    @property
    def logit_stride(self) -> int:
        """The stride of the decoder's logits."""
        return 4 if self.decoder == "upernet" else self.output_stride


@dataclass
class Model:
    """The reference forward over ``params``; ``training`` selects batch
    statistics, dropout and the deep-supervision head. ``masks`` (training):
    the Dropout2d keep masks in the order the forward draws them, each
    (N, C) bool. ``new_stats``: BN name -> (mean, var, iter) after a
    training forward; ``batch_stats``: BN name -> the batch's (mean, biased
    variance)."""

    params: Dict[str, torch.Tensor]
    arch: Arch
    num: Numerics = field(default_factory=Numerics)
    training: bool = False
    masks: List[torch.Tensor] = field(default_factory=list)
    new_stats: Dict[str, Tuple[torch.Tensor, ...]] = field(default_factory=dict)
    batch_stats: Dict[str, Tuple[torch.Tensor, ...]] = field(default_factory=dict)
    eps: float = 1e-5
    momentum: float = 0.001
    dropout_p: float = 0.1
    remat: bool = False  # recompute the stem and each block in the backward (memory only)

    # -- layers --------------------------------------------------------------
    def _p(self, name):
        return self.params[name].to(self.num.dtype)

    def q(self, t):
        """``t`` as stored (``Numerics.low``)."""
        return t if self.num.low is None else _Stored.apply(t, self.num.low)

    def conv(self, x, name, *, stride=1, padding=0, dilation=1):
        w = self.q(self._p(name + ".weight"))
        b = self.params.get(name + ".bias")
        b = None if b is None else self.q(b.to(self.num.dtype))
        y = self.q(F.conv2d(self.q(x), w, b, stride, padding, dilation))
        n, o, h, wd = y.shape
        self.num.flops += 2 * n * o * h * wd * w.shape[1] * w.shape[2] * w.shape[3]
        return y

    def bn(self, x, name):
        w, b = self._p(name + ".weight"), self._p(name + ".bias")
        if not self.training:
            mean, var = self._p(name + ".running_mean"), self._p(name + ".running_var")
            y = (x - mean.view(1, -1, 1, 1)) / torch.sqrt(var.view(1, -1, 1, 1) + self.eps)
            return self.q(y * w.view(1, -1, 1, 1) + b.view(1, -1, 1, 1))
        # The reference SyncBN: one pass of sums, the biased variance
        # floored at eps, and a bias-corrected running average.
        n = x.shape[0] * x.shape[2] * x.shape[3]
        s = x.sum(dim=(0, 2, 3))
        ss = (x * x).sum(dim=(0, 2, 3))
        mean = s / n
        sumvar = ss - s * mean
        inv = torch.rsqrt(torch.clamp(sumvar / n, min=self.eps))
        with torch.no_grad():
            it = self._p(name + "._running_iter")
            keep = 1.0 - self.momentum
            new_it = it * keep + 1.0
            new_mean = (self._p(name + ".running_mean") * it * keep + mean) / new_it
            new_var = (self._p(name + ".running_var") * it * keep + sumvar / (n - 1.0)) / new_it
            self.new_stats[name] = (new_mean.detach(), new_var.detach(), new_it)
            self.batch_stats[name] = (mean.detach(), (sumvar / n).detach())
        return self.q((x - mean.view(1, -1, 1, 1)) * (inv * w).view(1, -1, 1, 1)
                      + b.view(1, -1, 1, 1))

    def cbr(self, x, conv, bn, **kw):
        return F.relu(self.bn(self.conv(x, conv, **kw), bn))

    def dropout(self, x):
        if not self.training:
            return x
        keep = self.masks.pop(0).to(x.device).view(x.shape[0], x.shape[1], 1, 1)
        return self.q(torch.where(keep, x / (1.0 - self.dropout_p), 0.0))

    # -- encoder -------------------------------------------------------------
    def stem(self, x):
        """The deep stem: three 3x3 conv-BN-ReLU, the first of stride 2,
        then max pool 3/2/1."""
        x = self.cbr(x, "encoder.conv1", "encoder.bn1", stride=2, padding=1)
        x = self.cbr(x, "encoder.conv2", "encoder.bn2", padding=1)
        x = self.cbr(x, "encoder.conv3", "encoder.bn3", padding=1)
        return F.max_pool2d(x, 3, 2, 1)

    def _remat(self) -> bool:
        return self.remat and self.training and torch.is_grad_enabled()

    def encoder(self, x) -> List[torch.Tensor]:
        x = checkpoint(self.stem, x, use_reentrant=False) if self._remat() else self.stem(x)
        strides, dilations = [1, 2, 2, 2], [1, 1, 1, 1]
        if self.arch.encoder.endswith("dilated"):
            strides[2:], dilations[2:] = [1, 1], [2, 4]
        feats = []
        for s, blocks in enumerate(BLOCKS):
            for j in range(blocks):
                pre = f"encoder.layer{s + 1}.{j}"
                stride = strides[s] if j == 0 else 1
                d = max(dilations[s] // 2, 1) if j == 0 else dilations[s]
                if self._remat():
                    x = checkpoint(self.block, x, pre, stride, d, use_reentrant=False)
                else:
                    x = self.block(x, pre, stride, d)
            feats.append(x)
        return feats

    def block(self, x, pre, stride, d):
        """A Bottleneck: 1x1, 3x3 (stride, dilation d), 1x1, the residual."""
        out = self.cbr(x, pre + ".conv1", pre + ".bn1")
        out = self.cbr(out, pre + ".conv2", pre + ".bn2", stride=stride, padding=d, dilation=d)
        out = self.bn(self.conv(out, pre + ".conv3"), pre + ".bn3")
        if pre + ".downsample.0.weight" in self.params:
            x = self.bn(self.conv(x, pre + ".downsample.0", stride=stride), pre + ".downsample.1")
        return F.relu(self.q(out + x))

    # -- decoders ------------------------------------------------------------
    def pool(self, x, s, valid):
        if valid is None:
            return self.q(F.adaptive_avg_pool2d(x, s))
        return self.q(torch.cat([F.adaptive_avg_pool2d(x[i:i + 1, :, :h, :w], s)
                                 for i, (h, w) in enumerate(valid)]))

    def onto(self, g, hw, valid):
        """Grid ``g`` upsampled bilinearly (half-pixel) onto the map, or
        onto each sample's valid region with zeros beyond it."""
        if valid is None:
            return self.q(F.interpolate(g, size=tuple(hw), mode="bilinear", align_corners=False))
        out = g.new_zeros((g.shape[0], g.shape[1], *hw))
        for i, (h, w) in enumerate(valid):
            out[i, :, :h, :w] = F.interpolate(g[i:i + 1], size=(h, w), mode="bilinear",
                                              align_corners=False)[0]
        return self.q(out)

    def resize(self, x, hw):
        if tuple(x.shape[2:]) == tuple(hw):
            return x
        return self.q(F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False))

    def ppm_deepsup(self, feats, valid):
        conv5 = feats[-1]
        hw = conv5.shape[2:]
        outs = [conv5]
        for i, s in enumerate(SCALES):
            g = self.cbr(self.pool(conv5, s, valid), f"decoder.ppm.{i}.1", f"decoder.ppm.{i}.2")
            outs.append(self.onto(g, hw, valid))
        x = self.cbr(torch.cat(outs, 1), "decoder.conv_last.0", "decoder.conv_last.1", padding=1)
        x = self.conv(self.dropout(x), "decoder.conv_last.4")
        if not self.training:
            return x, None
        ds = self.cbr(feats[-2], "decoder.cbr_deepsup.0", "decoder.cbr_deepsup.1", padding=1)
        return x, self.conv(self.dropout(ds), "decoder.conv_last_deepsup")

    def upernet(self, feats, valid):
        conv5 = feats[-1]
        hw = conv5.shape[2:]
        outs = [conv5]
        for i, s in enumerate(SCALES):
            g = self.onto(self.pool(conv5, s, valid), hw, valid)
            outs.append(self.cbr(g, f"decoder.ppm_conv.{i}.0", f"decoder.ppm_conv.{i}.1"))
        f = self.cbr(torch.cat(outs, 1), "decoder.ppm_last_conv.0", "decoder.ppm_last_conv.1",
                     padding=1)
        fpn = [f]
        for i in reversed(range(len(feats) - 1)):
            lat = self.cbr(feats[i], f"decoder.fpn_in.{i}.0", f"decoder.fpn_in.{i}.1")
            f = self.q(lat + self.resize(f, lat.shape[2:]))
            fpn.append(self.cbr(f, f"decoder.fpn_out.{i}.0.0", f"decoder.fpn_out.{i}.0.1",
                                padding=1))
        fpn.reverse()
        fused = torch.cat([fpn[0]] + [self.resize(p, fpn[0].shape[2:]) for p in fpn[1:]], 1)
        x = self.cbr(fused, "decoder.conv_last.0.0", "decoder.conv_last.0.1", padding=1)
        return self.conv(x, "decoder.conv_last.1"), None

    def forward(self, x, valid_hw: Optional[Sequence[Tuple[int, int]]] = None):
        """Logits at decoder resolution (and the deep-supervision logits in
        training, else None) of the normalised NCHW ``x``. ``valid_hw``:
        each sample's image extent inside the canvas, in input pixels."""
        feats = self.encoder(self.q(x.to(self.num.dtype)))
        valid = None
        if valid_hw is not None:
            os_ = self.arch.output_stride
            valid = [(-(-h // os_), -(-w // os_)) for h, w in valid_hw]
        if self.arch.decoder == "ppm_deepsup":
            return self.ppm_deepsup(feats, valid)
        if self.arch.decoder == "upernet":
            return self.upernet(feats, valid)
        raise ValueError(f"no reference decoder {self.arch.decoder!r}")


class _ConvCounter(Model):
    """The reference forward with BN left out (it keeps shapes and counts
    no FLOPs), which makes counting on meta tensors several times faster."""

    def bn(self, x, name):
        return x


def forward_flops(arch: Arch, shape, *, training: bool = False) -> int:
    """Multiply-adds x2 of every convolution of one forward at input
    ``shape`` (N, 3, H, W), counted on meta tensors (no compute)."""
    params = param_shapes(arch, device="meta")
    model = _ConvCounter(params, arch, Numerics(), training=training)
    if training:
        n = shape[0]
        model.masks = [torch.ones(n, 512, dtype=torch.bool, device="meta")] * 2
    model.forward(torch.empty(shape, device="meta"))
    return model.num.flops


# -- parameter shapes ----------------------------------------------------------
def _bn(out: dict, name: str, c: int, device):
    for k, fill in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                    ("running_var", 1.0)):
        out[f"{name}.{k}"] = torch.full((c,), fill, device=device)
    out[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64, device=device)
    out[f"{name}._running_iter"] = torch.ones(1, device=device)


def _conv(out: dict, name: str, cin: int, cout: int, k: int, device, bias=False):
    out[f"{name}.weight"] = torch.empty((cout, cin, k, k), device=device)
    if bias:
        out[f"{name}.bias"] = torch.zeros(cout, device=device)


def param_shapes(arch: Arch, device="cpu") -> Dict[str, torch.Tensor]:
    """Every state_dict entry of the configuration, BN ones filled with the
    identity (weight 1, bias 0, running mean 0, variance 1, iter 1) and
    conv weights left empty."""
    out: dict = {}
    _conv(out, "encoder.conv1", 3, 64, 3, device)
    _bn(out, "encoder.bn1", 64, device)
    _conv(out, "encoder.conv2", 64, 64, 3, device)
    _bn(out, "encoder.bn2", 64, device)
    _conv(out, "encoder.conv3", 64, 128, 3, device)
    _bn(out, "encoder.bn3", 128, device)
    inplanes = 128
    for s, (blocks, width) in enumerate(zip(BLOCKS, PLANES)):
        for j in range(blocks):
            pre = f"encoder.layer{s + 1}.{j}"
            cin = inplanes if j == 0 else width * 4
            _conv(out, pre + ".conv1", cin, width, 1, device)
            _bn(out, pre + ".bn1", width, device)
            _conv(out, pre + ".conv2", width, width, 3, device)
            _bn(out, pre + ".bn2", width, device)
            _conv(out, pre + ".conv3", width, width * 4, 1, device)
            _bn(out, pre + ".bn3", width * 4, device)
            if j == 0:
                _conv(out, pre + ".downsample.0", cin, width * 4, 1, device)
                _bn(out, pre + ".downsample.1", width * 4, device)
        inplanes = width * 4
    fc, nc = arch.fc_dim, arch.num_class
    if arch.decoder == "ppm_deepsup":
        for i in range(len(SCALES)):
            _conv(out, f"decoder.ppm.{i}.1", fc, 512, 1, device)
            _bn(out, f"decoder.ppm.{i}.2", 512, device)
        _conv(out, "decoder.conv_last.0", fc + len(SCALES) * 512, 512, 3, device)
        _bn(out, "decoder.conv_last.1", 512, device)
        _conv(out, "decoder.conv_last.4", 512, nc, 1, device, bias=True)
        _conv(out, "decoder.cbr_deepsup.0", fc // 2, fc // 4, 3, device)
        _bn(out, "decoder.cbr_deepsup.1", fc // 4, device)
        _conv(out, "decoder.conv_last_deepsup", fc // 4, nc, 1, device, bias=True)
    elif arch.decoder == "upernet":
        d = arch.fpn_dim
        for i in range(len(SCALES)):
            _conv(out, f"decoder.ppm_conv.{i}.0", fc, 512, 1, device)
            _bn(out, f"decoder.ppm_conv.{i}.1", 512, device)
        _conv(out, "decoder.ppm_last_conv.0", fc + len(SCALES) * 512, d, 3, device)
        _bn(out, "decoder.ppm_last_conv.1", d, device)
        for i, c in enumerate((256, 512, 1024)):
            _conv(out, f"decoder.fpn_in.{i}.0", c, d, 1, device)
            _bn(out, f"decoder.fpn_in.{i}.1", d, device)
            _conv(out, f"decoder.fpn_out.{i}.0.0", d, d, 3, device)
            _bn(out, f"decoder.fpn_out.{i}.0.1", d, device)
        _conv(out, "decoder.conv_last.0.0", 4 * d, d, 3, device)
        _bn(out, "decoder.conv_last.0.1", d, device)
        _conv(out, "decoder.conv_last.1", d, nc, 1, device, bias=True)
    else:
        raise ValueError(f"no reference decoder {arch.decoder!r}")
    return out


def eval_params(arch: Arch, seed: int, device, images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Weights to evaluate, like a trained network's where the seeded
    initialisation is not: ``seeded_params`` with each residual block's
    last BN (``bn3``) weighing 0.2, as a trained ResNet's residual branches
    are small (at 1 a random one is chaotic: rounding alone, bfloat16
    against float32, tips the argmax of a third of its pixels), and every
    BN's running statistics set to its batch statistics over ``images``
    (N, 3, H, W, normalised), so that each layer's eval output is of unit
    scale instead of growing through the 50 layers. Computed in float32,
    deterministically."""
    params = seeded_params(arch, seed, device, residual_bn=RESIDUAL_BN)
    n = images.shape[0]
    model = Model(params, arch, Numerics(torch.float32), training=True,
                  masks=[torch.ones(n, 512, dtype=torch.bool, device=device)] * 2)
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = True, False
    try:
        with torch.no_grad():
            model.forward(images.to(device))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = saved
    for name, (mean, var) in model.batch_stats.items():
        params[name + ".running_mean"] = mean
        params[name + ".running_var"] = var
    return params


RESIDUAL_BN = 0.2  # the weight of each residual block's last BN, to evaluate


def seeded_params(arch: Arch, seed: int, device, residual_bn: float = 1.0
                  ) -> Dict[str, torch.Tensor]:
    """The configuration's weights from ``seed``, made on ``device`` in one
    draw: every conv weight normal with std sqrt(2 / fan), fan_out in the
    encoder and fan_in in the decoder (the He scheme of the CSAILVision
    and JAX trainers, the program's own initialisation); BN weight 1 (each
    residual block's last, ``bn3``, ``residual_bn``), bias 0 (1e-4 in the
    decoder), running mean 0, variance 1; conv biases 0. The same seed and
    device give the same weights."""
    params = param_shapes(arch, device=device)
    convs = [k for k, v in params.items() if k.endswith(".weight") and v.dim() == 4]
    total = sum(params[k].numel() for k in convs)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device)
    lo = 0
    for k in convs:
        t = params[k]
        o, i, kh, kw = t.shape
        fan = (o if k.startswith("encoder.") else i) * kh * kw
        params[k] = flat[lo:lo + t.numel()].view_as(t).mul_(math.sqrt(2.0 / fan))
        lo += t.numel()
    for k in params:
        if k.startswith("decoder.") and k.endswith(".bias") and k[:-5] + ".running_mean" in params:
            params[k].fill_(1e-4)
        elif k.startswith("encoder.layer") and k.endswith(".bn3.weight"):
            params[k].fill_(residual_bn)
    return params
