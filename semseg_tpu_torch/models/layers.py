"""Shared building blocks (``semseg_tpu/models/layers.py``), NCHW.

Parameters and batch-norm statistics stay float32. A convolution runs in the
dtype of its input (the compute dtype, bfloat16 by default): its weight is
cast at the call, as flax casts it under ``dtype=``, and the gradient flows
back through the cast to the float32 parameter. Batch norm computes in
float32 and casts back to the input dtype.

Module and slot names follow the reference's ``state_dict`` keys, so its
``.pth`` files load with ``load_state_dict(strict=True)``.

The modules whose output pixel depends on their input pixel alone in eval
(``ROWWISE``: batch norm, dropout, the activations) also run over a map
held as row bands (``parallel/spatial.band_apply``): ``forward_bands``
takes the bands, each on its device, and returns them transformed, reading
the module's parameters on each band's device. In training a batch norm's
statistics are then the whole map's and dropout's channel mask is drawn
once for all the bands (``cli.train TPU.spatial``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
import torch.nn.functional as F

from semseg_tpu_torch.ops.norm import batch_norm_inference, batch_norm_train_bands


_recompute = threading.local()


@contextlib.contextmanager
def recomputing():
    """The context of an activation checkpoint's recompute in the backward
    (``models.resnet.ResBlock`` under ``TPU.remat``): a training BN there
    normalises with the batch statistics as the first forward did, but
    leaves its running statistics and ``_running_iter`` as that forward
    left them, so that a step advances them once, as JAX's functional
    ``batch_stats`` do."""
    _recompute.active = True
    try:
        yield
    finally:
        _recompute.active = False


def in_recompute() -> bool:
    return getattr(_recompute, "active", False)


class Dropout2d(nn.Module):
    """Channel dropout (``nn.Dropout2d``'s semantics): in training, each
    (sample, channel) map is zeroed with probability ``p`` and the rest are
    scaled by ``1 / (1 - p)``; identity in eval.

    The mask is drawn from ``generator``, a CPU ``torch.Generator`` that the
    trainer owns and seeds per step (``parallel.train_step``), and then
    moved to the input's device, so a run is reproducible and the card
    draws the same masks as the CPU. Without a generator the global CPU
    generator is used. With ``process_group`` (data parallelism, every rank
    at batch N) rank r draws the global batch's (N * ranks, C) mask and keeps
    its rows [r*N, (r+1)*N): the ranks' masks are those of one process at
    the global batch, not copies of one another. Over bands
    (``forward_bands``) the (N, C) mask is drawn once and applied to each
    band, so a split map drops the channels the whole map would.
    """

    # In eval each output pixel depends on its input pixel alone, so the
    # banded forward (``parallel/spatial.run_banded``) applies the module to
    # each band as it is.
    ROWWISE = True

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None
        self.process_group = None

    def forward(self, x):
        return self.forward_bands([x])[0]

    def forward_bands(self, parts):
        if not self.training or self.p == 0.0:
            return list(parts)
        n, c = parts[0].shape[:2]
        rank, world = 0, 1
        if self.process_group is not None:
            rank = dist.get_rank(self.process_group)
            world = dist.get_world_size(self.process_group)
        keep = torch.rand(n * world, c, generator=self.generator)[rank * n:(rank + 1) * n] >= self.p
        keep = keep.view(n, c, 1, 1)
        if any(x.is_cuda for x in parts):
            # A copy from pinned memory does not make the host wait for the
            # card's queue to drain, as one from pageable memory does.
            keep = keep.pin_memory()
        return [torch.where(keep.to(x.device, non_blocking=True), x / (1.0 - self.p), 0.0)
                for x in parts]

    def extra_repr(self):
        return f"p={self.p}"


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose f32 parameters are cast to the input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class BatchNorm2d(nn.BatchNorm2d):
    """The reference SyncBN, f32 math (``ops.norm``).

    Eval mode normalises with the running statistics; training mode with
    the batch's (``batch_norm_train``) and advances the running statistics
    by the reference's bias-corrected EMA (momentum 0.001). With
    ``process_group`` (data parallelism) the batch is every rank's: the
    statistics are all-reduced, and every rank keeps the same running ones.

    Over bands (``forward_bands``, each band on its device) the statistics
    are the whole map's (``ops.norm.batch_norm_train_bands``) and the
    running statistics advance once.

    Buffers: ``nn.BatchNorm2d``'s, plus ``_running_iter`` (shape (1,),
    default 1), the EMA's bias-correction accumulator under the reference's
    own name (the JAX package's ``batch_stats.iter``). A state_dict without
    ``_running_iter`` (a file written before it existed) loads strict with 1
    filled in, the JAX package's initial value.

    Inside an activation checkpoint's recompute (``recomputing``) training
    mode computes the same output and does not touch the buffers. With a
    process group the recompute all-reduces the statistics again; every
    rank recomputes the same blocks in the same order of one backward.
    """

    ROWWISE = True  # in eval (see Dropout2d)

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.001):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.register_buffer("_running_iter", torch.ones(1))
        self.process_group = None

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        key = prefix + "_running_iter"
        if key not in state_dict:
            state_dict[key] = torch.ones(1)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x):
        return self.forward_bands([x])[0]

    def forward_bands(self, parts):
        if not self.training:
            return [batch_norm_inference(
                x, *(t.to(x.device, non_blocking=True) for t in (
                    self.weight, self.bias, self.running_mean, self.running_var)),
                eps=self.eps) for x in parts]
        ys, mean, var, it = batch_norm_train_bands(
            parts, self.weight, self.bias, self.running_mean, self.running_var,
            self._running_iter, eps=self.eps, momentum=self.momentum,
            group=self.process_group,
        )
        if in_recompute():
            return ys
        self.running_mean.copy_(mean)
        self.running_var.copy_(var)
        self._running_iter.copy_(it)
        return ys


_ACTS = {"relu": F.relu, "relu6": F.relu6}


def apply_act(x, act: Optional[str]):
    if act is None:
        return x
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    return _ACTS[act](x)


class _Act(nn.Module):
    ROWWISE = True  # see Dropout2d

    def __init__(self, act: str):
        super().__init__()
        if act not in _ACTS:
            raise ValueError(f"unknown activation {act!r}")
        self.act = act

    def forward(self, x):
        return apply_act(x, self.act)

    def forward_bands(self, parts):
        return [apply_act(x, self.act) for x in parts]

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
