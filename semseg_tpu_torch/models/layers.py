"""Shared building blocks (``semseg_tpu/models/layers.py``), NCHW.

Parameters and batch-norm statistics stay float32. A convolution runs in the
dtype of its input (the compute dtype, bfloat16 by default): its weight is
cast at the call, as flax casts it under ``dtype=``. Batch norm computes in
float32 and casts back to the input dtype.

Module and slot names follow the reference's ``state_dict`` keys, so its
``.pth`` files load with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from typing import Optional

from torch import nn
import torch.nn.functional as F

from semseg_tpu_torch.ops.norm import batch_norm_inference

# Channel dropout, identity in eval (torch's own module has the semantics).
Dropout2d = nn.Dropout2d


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose f32 parameters are cast to the input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class BatchNorm2d(nn.BatchNorm2d):
    """Inference batch norm on running statistics, f32 math.

    The buffers are ``nn.BatchNorm2d``'s, so reference keys load as they
    are. Training statistics come with the training port.
    """

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "batch-norm training is not ported yet; call .eval()"
            )
        return batch_norm_inference(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            eps=self.eps,
        )


_ACTS = {"relu": F.relu, "relu6": F.relu6}


def apply_act(x, act: Optional[str]):
    if act is None:
        return x
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    return _ACTS[act](x)


class _Act(nn.Module):
    def __init__(self, act: str):
        super().__init__()
        if act not in _ACTS:
            raise ValueError(f"unknown activation {act!r}")
        self.act = act

    def forward(self, x):
        return apply_act(x, self.act)

    def extra_repr(self):
        return self.act


class ConvBN(nn.Sequential):
    """Conv2d (no bias) → BatchNorm2d → optional activation.

    A ``Sequential`` so that its keys are the reference's ``.0`` (conv) and
    ``.1`` (BN), as in ``conv3x3_bn_relu`` and the ResNet ``downsample``.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, *,
                 stride: int = 1, padding: Optional[int] = None,
                 dilation: int = 1, groups: int = 1,
                 act: Optional[str] = "relu"):
        if padding is None:
            padding = (kernel_size // 2) * dilation
        layers = [
            Conv2d(in_ch, out_ch, kernel_size, stride=stride, padding=padding,
                   dilation=dilation, groups=groups, bias=False),
            BatchNorm2d(out_ch),
        ]
        if act is not None:
            layers.append(_Act(act))
        super().__init__(*layers)
