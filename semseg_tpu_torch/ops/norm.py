"""Batch norm with the reference SyncBN's rules (``semseg_tpu/ops/norm.py``).

Inference: ``(x - running_mean) / sqrt(running_var + eps) * weight + bias``,
folded into one affine computed in the accumulation dtype and cast back to
``x.dtype`` (``F.batch_norm``'s semantics).

Training (``batch_norm_train``) keeps the reference's quirks exactly, which
``F.batch_norm`` in training mode does not:

* statistics in float32 over a bfloat16 input, from one pass of ``s`` and
  ``ss`` with ``sumvar = ss - s * mean``;
* normalisation by ``rsqrt(max(biased_var, eps))``, not ``sqrt(var + eps)``;
* momentum 0.001 and a bias-corrected EMA through the accumulator ``iter``
  (``iter := iter * (1 - m) + 1``, ``running := (running * iter * (1 - m) +
  batch_stat) / new_iter``), with the *unbiased* variance entering it;
* more than one element per channel over the whole batch, else
  ``ValueError``.

With ``group``, a ``torch.distributed`` process group whose ranks each
hold a slice of the batch (the JAX package's ``axis_name``), the statistics
are the whole batch's: one all-reduce of ``cat(s, ss)`` per call, which is
differentiable: its backward all-reduces the statistics' gradient, as
JAX's ``psum`` transposes to ``psum`` (a plain ``dist.all_reduce`` would
drop the other ranks' part of it). The count needs no reduction: every
rank's ``x`` has one shape (the trainer pads the ranks to one canvas), so
it is the local count times the ranks, JAX's static ``global_n``, and the
arithmetic is the one-process arithmetic on the global sums (a group of
one rank computes what no group does, bit for bit). Every rank then holds
the same running statistics. The gradient is otherwise autograd's through
these ops.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .dtypes import acc_dtype


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of ``group``; the gradient is summed the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x, group=None):
    """``x`` summed over the ranks of ``group`` (differentiable); ``x`` itself
    without a group."""
    return x if group is None else _AllReduceSum.apply(x, group)


def group_size(group=None) -> int:
    """The ranks of ``group``; 1 without a group."""
    return 1 if group is None else dist.get_world_size(group)


def batch_norm_inference(x, weight, bias, running_mean, running_var, *, eps=1e-5):
    """Batch norm with running statistics over the channels of NCHW ``x``."""
    adt = acc_dtype(x.dtype)
    inv = torch.rsqrt(running_var + eps)
    w = (weight * inv).to(adt).view(1, -1, 1, 1)
    b = (bias - running_mean * weight * inv).to(adt).view(1, -1, 1, 1)
    return (x.to(adt) * w + b).to(x.dtype)


def batch_norm_train(x, weight, bias, running_mean, running_var, running_iter, *,
                     eps=1e-5, momentum=0.001, group=None):
    """Training batch norm over the channels of NCHW ``x``, over the whole
    batch of ``group``'s ranks when given (every rank's ``x`` of one shape).

    Returns ``(y, new_running_mean, new_running_var, new_running_iter)``;
    the new statistics carry no gradient.
    """
    local_n = x.shape[0] * x.shape[2] * x.shape[3]
    global_n = local_n * group_size(group)
    if global_n <= 1:
        raise ValueError(
            f"batch_norm_train needs >1 element per channel, got {global_n} (input "
            f"{tuple(x.shape)}); a global batch of 1 reaching a 1x1 feature map cannot "
            "estimate batch statistics (the reference asserts the same)"
        )
    adt = acc_dtype(x.dtype)
    xf = x.to(adt)
    s = xf.sum(dim=(0, 2, 3))
    ss = (xf * xf).sum(dim=(0, 2, 3))
    n = global_n
    s, ss = all_reduce_sum(torch.cat([s, ss]), group).chunk(2)
    mean = s / n
    sumvar = ss - s * mean
    bias_var = sumvar / n
    inv_std = torch.rsqrt(torch.clamp(bias_var, min=eps))

    with torch.no_grad():
        keep = 1.0 - momentum
        unbias_var = sumvar / (n - 1.0)
        new_iter = running_iter * keep + 1.0
        new_mean = (running_mean * running_iter * keep + mean) / new_iter
        new_var = (running_var * running_iter * keep + unbias_var) / new_iter

    y = (xf - mean.view(1, -1, 1, 1)) * (inv_std * weight).view(1, -1, 1, 1) \
        + bias.view(1, -1, 1, 1)
    return y.to(x.dtype), new_mean, new_var, new_iter
