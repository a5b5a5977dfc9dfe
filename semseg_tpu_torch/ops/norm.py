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

``batch_norm_train_bands`` is the same call over a map held as row bands
(``cli.train TPU.spatial``: each image's height split across devices):
each band sums its own (s, ss) on its device, the bands' sums are added on
the first band's device, the group's all-reduce follows once, and the
count is the rank's whole map's. The statistics and the running update are
then the unsplit call's arithmetic; each band is normalised on its own
device, and the statistics' gradient reaches each band through the copies.
``batch_norm_train`` is its one-band case.

Over bands on several cards, autograd runs each card's part of the backward
on a thread of its own, so the moment at which a statistics all-reduce's
backward becomes ready depends on the other cards' threads, and two ranks
could reach the group's collectives in different orders (mismatched or
hung all-reduces). Inside ``ordered_collectives`` every differentiable
``all_reduce_sum`` takes the previous one's output as an input (its
gradient for it is None): the backward then runs them in the reverse of
the forward's order, which is the same on every rank.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

from .dtypes import acc_dtype


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of ``group``; the gradient is summed the same way.
    ``after``: outputs of earlier calls whose backward must come after this
    one's (``ordered_collectives``); they get no gradient."""

    @staticmethod
    def forward(ctx, x, group, *after):
        ctx.group, ctx.after = group, len(after)
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return (grad, None) + (None,) * ctx.after


_order = threading.local()


@contextlib.contextmanager
def ordered_collectives():
    """Chains the differentiable ``all_reduce_sum`` calls made inside, so
    that their backward all-reduces run in one order on every rank (module
    docstring)."""
    _order.last = None
    _order.active = True
    try:
        yield
    finally:
        _order.active = False
        _order.last = None


def all_reduce_sum(x, group=None):
    """``x`` summed over the ranks of ``group`` (differentiable); ``x`` itself
    without a group."""
    if group is None:
        return x
    if not (getattr(_order, "active", False) and x.requires_grad and torch.is_grad_enabled()):
        return _AllReduceSum.apply(x, group)
    after = () if _order.last is None else (_order.last,)
    _order.last = _AllReduceSum.apply(x, group, *after)
    return _order.last


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
    (y,), *stats = batch_norm_train_bands([x], weight, bias, running_mean, running_var,
                                          running_iter, eps=eps, momentum=momentum,
                                          group=group)
    return (y, *stats)


def batch_norm_train_bands(parts, weight, bias, running_mean, running_var, running_iter, *,
                           eps=1e-5, momentum=0.001, group=None):
    """``batch_norm_train`` over an NCHW map held as row bands ``parts`` (in
    order, each on its band's device; the parameters and statistics on the
    first band's), over the whole map and ``group``'s ranks.

    Returns ``(ys, new_running_mean, new_running_var, new_running_iter)``,
    ``ys`` the normalised bands, each on its band's device.
    """
    n_, c_, _, w_ = parts[0].shape
    shape = (n_, c_, sum(p.shape[2] for p in parts), w_)
    local_n = shape[0] * shape[2] * shape[3]
    global_n = local_n * group_size(group)
    if global_n <= 1:
        raise ValueError(
            f"batch_norm_train needs >1 element per channel, got {global_n} (input "
            f"{shape}); a global batch of 1 reaching a 1x1 feature map cannot "
            "estimate batch statistics (the reference asserts the same)"
        )
    adt = acc_dtype(parts[0].dtype)
    dev0 = parts[0].device
    xfs, sums = [], None
    for x in parts:
        xf = x.to(adt)
        xfs.append(xf)
        band = torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))])
        band = band.to(dev0, non_blocking=True)
        sums = band if sums is None else sums + band
    n = global_n
    s, ss = all_reduce_sum(sums, group).chunk(2)
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

    scale = inv_std * weight
    ys = []
    for x, xf in zip(parts, xfs):
        m, a, b = (t.to(x.device, non_blocking=True).view(1, -1, 1, 1)
                   for t in (mean, scale, bias))
        ys.append(((xf - m) * a + b).to(x.dtype))
    return ys, new_mean, new_var, new_iter
