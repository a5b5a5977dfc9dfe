"""Each image's height split across devices: the JAX package's spatial
sharding, in eval (``cli.eval --spatial N``) and in training (``cli.train
TPU.spatial N``).

JAX puts each bucketed level on a mesh with its height sharded
(``semseg_tpu/parallel/mesh.py::spatial_sharding``) and lets GSPMD insert
the halo exchanges. Here one process drives the devices, as JAX's single
controller does, and the exchanges are written out:

* ``BandPlan``: the rows each band holds at every stride. The stride-8 rows
  ``ceil(Hp / 8)`` of the padded canvas are cut into N contiguous,
  near-equal bands; at stride ``2^k`` a band holds rows ``[a * 8 / 2^k, b *
  8 / 2^k)``, and the last band ends at that level's height ``ceil(Hp /
  2^k)``. So every interior boundary stays exact through the stride-2 stem
  conv, the max pool and the stride-2 convs of ``layer2`` or MobileNetV2.
  When N exceeds ``ceil(Hp / 8)`` the last bands are empty and skipped.
* ``halo_rows``: rows ``[lo, hi)`` of a banded map on one device. For an op
  with kernel k, stride s, padding p and dilation d, output rows ``[o0,
  o1)`` need input rows ``[o0 * s - p, (o1 - 1) * s - p + d * (k - 1)]``.
  Rows outside the map take the op's padding (zeros for a conv, -inf for
  the max pool), and the op runs with padding ``(0, p_w)``; rows another
  band holds are copied from it, from as many bands as the rows span (a
  dilation-4 conv over bands of one row reads four of them).
* ``band_conv``, ``band_max_pool``, ``band_apply`` (a module that acts on
  each pixel alone in eval: batch norm, dropout, an activation; in
  training through its ``forward_bands``, whose batch norm takes the
  whole map's statistics and whose dropout draws one mask for every band)
  and ``run_banded`` (a ``Sequential`` of those) are the model's ops on a
  ``Bands``; the banded encoders and decoders are in ``models/`` beside
  the modules whose parameters they use. ``split_labels`` cuts a training
  batch's stride-8 labels into the plan's rows.

An op takes its modules as a list: in eval one copy per band (``mods[j]``
on band j's device), in training the one model's module, on the first
band's device, for every band (``[module]``). A conv then reads its
parameters through ``Tensor.to(band device, dtype)``, and autograd sums
the bands' gradients onto the one parameter; a halo row's gradient goes
back to the band that sent it through the same copies and ``torch.cat``.

Bands that share a device read each other's rows as slices; across cards a
halo moves with ``Tensor.to(device, non_blocking=True)``, which PyTorch
orders against both cards' current streams. Nothing here synchronises with
the host, so the cards run their bands at once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

#: The coarsest stride a band plan cuts at: the output stride of the
#: encoders that run banded.
BASE_STRIDE = 8


class BandPlan:
    """Rows of each non-empty band at strides 1, 2, 4 and 8 of an
    ``height``-row canvas cut into ``n`` bands."""

    def __init__(self, height: int, n: int):
        if height < 1 or n < 1:
            raise ValueError(f"BandPlan: a {height}-row canvas in {n} bands")
        self.canvas_height = height
        rows = -(-height // BASE_STRIDE)
        base, extra = divmod(rows, n)
        bounds = [0]
        for i in range(n):
            bounds.append(bounds[-1] + base + (i < extra))
        #: Stride-8 rows [a, b) of each non-empty band, in order.
        self.spans: List[Tuple[int, int]] = [(a, b) for a, b in zip(bounds, bounds[1:]) if b > a]

    @property
    def count(self) -> int:
        """The non-empty bands."""
        return len(self.spans)

    def height(self, stride: int) -> int:
        """The map's height at ``stride``: ``ceil(canvas height / stride)``."""
        return -(-self.canvas_height // stride)

    def rows(self, stride: int) -> List[Tuple[int, int]]:
        """Rows [r0, r1) of each non-empty band at ``stride`` (1, 2, 4, 8)."""
        if stride not in (1, 2, 4, 8):
            raise NotImplementedError(
                f"a band plan cuts strides 1-{BASE_STRIDE}, not {stride}: the banded "
                "encoders have output stride 8 (ROADMAP item 17c)")
        k = BASE_STRIDE // stride
        last = self.count - 1
        return [(a * k, self.height(stride) if j == last else b * k)
                for j, (a, b) in enumerate(self.spans)]


@dataclass
class Bands:
    """An NCHW map at ``stride`` held as row bands: ``parts[j]`` holds rows
    ``plan.rows(stride)[j]``, on band j's device."""

    parts: List[torch.Tensor]
    plan: BandPlan
    stride: int

    @property
    def rows(self) -> List[Tuple[int, int]]:
        return self.plan.rows(self.stride)

    @property
    def height(self) -> int:
        return self.plan.height(self.stride)

    def map(self, fn) -> "Bands":
        """``fn`` applied to each band (a pixel-wise op)."""
        return Bands([fn(p) for p in self.parts], self.plan, self.stride)

    def zip(self, other: "Bands", fn) -> "Bands":
        """``fn(mine, theirs)`` per band, over two maps cut alike."""
        if other.stride != self.stride:
            raise ValueError(f"bands at strides {self.stride} and {other.stride}")
        return Bands([fn(a, b) for a, b in zip(self.parts, other.parts)], self.plan,
                     self.stride)


def split_rows(x: torch.Tensor, plan: BandPlan, devices: Sequence, stride: int = 1) -> Bands:
    """A whole NCHW map at ``stride`` cut into ``plan``'s bands, band j sent
    to ``devices[j]``."""
    return Bands([x[:, :, r0:r1].to(d, non_blocking=True)
                  for (r0, r1), d in zip(plan.rows(stride), devices)], plan, stride)


def split_labels(label: torch.Tensor, plan: BandPlan, devices: Sequence) -> List[torch.Tensor]:
    """A training batch's (N, h, w) labels at stride 8 cut into ``plan``'s
    stride-8 rows, band j's sent to ``devices[j]``."""
    if label.shape[1] != plan.height(BASE_STRIDE):
        raise ValueError(f"labels of {label.shape[1]} rows for a {plan.canvas_height}-row "
                         f"canvas at stride {BASE_STRIDE} ({plan.height(BASE_STRIDE)} rows)")
    return [label[:, r0:r1].to(d, non_blocking=True)
            for (r0, r1), d in zip(plan.rows(BASE_STRIDE), devices)]


def gather(x: Bands, device) -> torch.Tensor:
    """The whole map on ``device``, its bands stacked in order."""
    parts = [p.to(device, non_blocking=True) for p in x.parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)


def _fill_rows(like: torch.Tensor, rows: int, device, fill: float) -> torch.Tensor:
    n, c, _, w = like.shape
    return torch.empty((n, c, rows, w), dtype=like.dtype, device=device,
                       memory_format=torch.channels_last).fill_(fill)


def halo_rows(x: Bands, lo: int, hi: int, device, fill: float = 0.0) -> torch.Tensor:
    """Rows ``[lo, hi)`` of the banded map ``x`` on ``device``: rows outside
    ``[0, x.height)`` are ``fill``, the others copied from the bands that
    hold them (none copied when one band on ``device`` holds them all)."""
    pieces = []
    if lo < 0:
        pieces.append(_fill_rows(x.parts[0], min(hi, 0) - lo, device, fill))
    for (r0, r1), part in zip(x.rows, x.parts):
        a, b = max(lo, r0), min(hi, r1)
        if a < b:
            pieces.append(part[:, :, a - r0:b - r0].to(device, non_blocking=True))
    if hi > x.height:
        pieces.append(_fill_rows(x.parts[0], hi - max(lo, x.height), device, fill))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=2)


def _window(o0: int, o1: int, k: int, s: int, p: int, d: int) -> Tuple[int, int]:
    """Input rows [lo, hi) that output rows [o0, o1) of a (k, s, p, d) op read."""
    return o0 * s - p, (o1 - 1) * s - p + d * (k - 1) + 1


def _on(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Parameter ``t`` in ``like``'s dtype on ``like``'s device (cast, then
    copied: fewer bytes cross between cards in bf16)."""
    return t.to(like.dtype).to(like.device, non_blocking=True)


def _per_band(mods: Sequence[nn.Module], x: Bands) -> Sequence[nn.Module]:
    """Band j's module: ``mods[j]``, or the one module of ``[module]``."""
    return list(mods) * len(x.parts) if len(mods) == 1 else mods


def band_conv(convs: Sequence[nn.Conv2d], x: Bands) -> Bands:
    """Band j's conv (``convs[j]`` or the one of ``[conv]``, a
    ``layers.Conv2d``: its f32 parameters cast to the input's dtype and read
    on band j's device) over each band with its halo; zero padding rows,
    the conv's own padding across the width."""
    conv = convs[0]
    if conv.padding_mode != "zeros" or isinstance(conv.padding, str):
        raise NotImplementedError(f"band_conv: padding {conv.padding!r} {conv.padding_mode}")
    (kh, _), (sh, _), (ph, pw), (dh, _) = conv.kernel_size, conv.stride, conv.padding, \
        conv.dilation
    out_stride = x.stride * sh
    parts = []
    for c, (o0, o1), part in zip(_per_band(convs, x), x.plan.rows(out_stride), x.parts):
        inp = halo_rows(x, *_window(o0, o1, kh, sh, ph, dh), part.device)
        bias = None if c.bias is None else _on(c.bias, inp)
        parts.append(F.conv2d(inp, _on(c.weight, inp), bias, c.stride, (0, pw),
                              c.dilation, c.groups))
    return Bands(parts, x.plan, out_stride)


def band_max_pool(x: Bands, kernel_size: int, stride: int, padding: int) -> Bands:
    """``ops.pool.max_pool2d`` (floor mode, -inf padding) over each band
    with its halo."""
    out_stride = x.stride * stride
    parts = []
    for (o0, o1), part in zip(x.plan.rows(out_stride), x.parts):
        inp = halo_rows(x, *_window(o0, o1, kernel_size, stride, padding, 1), part.device,
                        fill=float("-inf"))
        parts.append(F.max_pool2d(inp, kernel_size, stride, (0, padding)))
    return Bands(parts, x.plan, out_stride)


def band_apply(mods: Sequence[nn.Module], x: Bands) -> Bands:
    """A ``ROWWISE`` module (``models/layers.py``: batch norm, dropout, an
    activation) over a banded map: the one module of ``[module]`` over
    every band through its ``forward_bands`` (in training, over the whole
    map), or each band's copy (``mods[j]``, on band j's device) on its
    band, in eval."""
    if len(mods) == 1:
        return Bands(mods[0].forward_bands(x.parts), x.plan, x.stride)
    for o in mods:
        if o.training:
            raise RuntimeError(f"banded {type(o).__name__} copies run in eval mode only; a "
                               "training forward passes its one module for every band")
    return Bands([o(p) for o, p in zip(mods, x.parts)], x.plan, x.stride)


def run_banded(mods: Sequence[nn.Module], x: Bands) -> Bands:
    """One module (``mods[j]``: its copy for band j; or ``[module]`` for
    every band) over a banded map: a
    ``Sequential`` in order, a conv with its halo, a row-wise module
    (``ROWWISE``, ``models/layers.py``) per band; anything else raises."""
    m = mods[0]
    if isinstance(m, nn.Sequential):
        for i in range(len(m)):
            x = run_banded([s[i] for s in mods], x)
        return x
    if isinstance(m, nn.Conv2d):
        return band_conv(mods, x)
    if getattr(m, "ROWWISE", False):
        return band_apply(mods, x)
    raise NotImplementedError(f"no banded form of {type(m).__name__} (ROADMAP item 17c)")
