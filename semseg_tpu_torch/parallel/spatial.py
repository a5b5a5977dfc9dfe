"""Each image's height split across devices: the eval half of the JAX
package's spatial sharding (``cli.eval --spatial N``).

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
  each pixel alone, in eval) and ``run_banded`` (a ``Sequential`` of those)
  are the model's ops on a ``Bands``; the banded encoders and decoders are
  in ``models/`` beside the modules whose parameters they use.

Bands that share a device read each other's rows as slices; across cards a
halo moves with ``Tensor.to(device, non_blocking=True)``, which PyTorch
orders against both cards' current streams. Nothing here synchronises with
the host, so the cards run their bands at once. Inference only: a module in
training mode raises.
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


def band_conv(convs: Sequence[nn.Conv2d], x: Bands) -> Bands:
    """``convs[j]`` (one conv's copy on band j's device, a ``layers.Conv2d``:
    its f32 parameters cast to the input's dtype) over each band with its
    halo; zero padding rows, the conv's own padding across the width."""
    conv = convs[0]
    if conv.padding_mode != "zeros" or isinstance(conv.padding, str):
        raise NotImplementedError(f"band_conv: padding {conv.padding!r} {conv.padding_mode}")
    (kh, _), (sh, _), (ph, pw), (dh, _) = conv.kernel_size, conv.stride, conv.padding, \
        conv.dilation
    out_stride = x.stride * sh
    parts = []
    for c, (o0, o1), part in zip(convs, x.plan.rows(out_stride), x.parts):
        inp = halo_rows(x, *_window(o0, o1, kh, sh, ph, dh), part.device)
        bias = None if c.bias is None else c.bias.to(inp.dtype)
        parts.append(F.conv2d(inp, c.weight.to(inp.dtype), bias, c.stride, (0, pw),
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
    """``mods[j]`` (one module's copy on band j's device) applied to band j:
    for a module whose output pixel depends on its input pixel alone (batch
    norm and dropout in eval, an activation)."""
    for m in mods:
        if m.training:
            raise RuntimeError(f"a banded {type(m).__name__} runs in eval mode only")
    return Bands([m(p) for m, p in zip(mods, x.parts)], x.plan, x.stride)


def run_banded(mods: Sequence[nn.Module], x: Bands) -> Bands:
    """One module (``mods[j]``: its copy for band j) over a banded map: a
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
