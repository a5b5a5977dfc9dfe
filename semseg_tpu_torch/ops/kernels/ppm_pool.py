"""Pyramid pooling of the PPM head: hand-written CUDA kernel and plain version.

Replaces ``semseg_tpu/ops/pallas/ppm_pool.py::pyramid_pool``: all the
adaptive-average-pool grids (1, 2, 3, 6) of one NHWC map from a single read
of the map, 50 bin means per channel, summed in f32 and rounded once to the
input dtype. The kernel (``csrc/ppm_pool.cu``) is bound by bytes: it reads
the map once, with 16-byte loads, where four ``adaptive_avg_pool2d`` calls
read it four times. It cuts the map at the bin boundaries into at most
11 x 11 cells, each inside or outside every bin, sums the cells in many
small blocks, and gives each bin its cells in a second small pass without
atomics. A map whose C is not a multiple of 16 bytes' worth of elements,
or whose address is not 16-byte aligned, is read with scalar loads.

With ``valid_hw`` it is the pad-aware form the batched engines need: each
sample is pooled over its own valid extent inside the padded canvas, which
is ``ops.resize_dynamic.adaptive_avg_pool2d_valid`` at the four scales
(``semseg_tpu/ops/resize_dynamic.py:70``, f32 einsums in the JAX package).
The same kernel reads each sample's extent from the device.

Band form (``pyramid_pool_band``): for a map whose rows are split across
devices (``cli.eval --spatial``), the kernel takes one band, rows ``[row0,
row0 + hb)`` of an H-row map, and writes each bin's f32 SUM over the
band's rows of the bin (over each sample's valid extent): (N, 50, C) in the
order scale 1, 2, 3, 6 and (i, j) row-major. ``band_sums_to_grids`` adds
the bands' sums, divides by the bin areas and rounds once, which is the
pad-aware form's result up to the order of the sums. It is one launch of
its own kernel (``ppm_band_kernel``): a block per 16 channels stages the
band's rows in shared memory, some of its warps copying while the others
sum the rows that have arrived, so nothing but the sums is allocated.

Band backward (``pyramid_pool_band_backward``): rows ``[row0, row0 + hb)``
of the dense form's input gradient, for training with each image's height
split in bands (``cli.train TPU.spatial``). It is the backward kernel with
its stores clipped to the band, so a band's rows are bit for bit the dense
backward's: the same terms in the same order, with the reciprocal areas of
the whole map rounded once on the host. ``pyramid_pool_bands`` is the
differentiable banded pool of training, one ``torch.autograd.Function``
around the whole of it: each band's band-form sums over the whole map's
bins (training pools unmasked canvases), added on the first band's device
and turned into the grids there; its backward sends the four grid
gradients to each band's device and launches the band backward there.
The boundary sits around the whole pool, not around one band's sums,
because autograd's gradient of ``band_sums_to_grids`` (``g / area``
through the sums) rounds apart from the dense backward's reciprocals.

The five forms are registered operators, ``semseg_tpu_torch::pyramid_pool``,
``::pyramid_pool_valid``, ``::pyramid_pool_band``, ``::pyramid_pool_backward``
and ``::pyramid_pool_band_backward``
(``torch.library.custom_op``), each with a fake implementation that gives
its output shapes, so ``torch.export`` keeps each call as one node and an
exported program launches the kernel (``serving.py``). The dense operator's
gradient (``register_autograd``) is the backward operator, a second
hand-written kernel (``ppm_pool_backward_kernel`` in the same source), which
writes ``grad_x[n, h, w, c] = sum over the scales s and the bins (i, j) of s
that hold (h, w) of g_s[n, i, j, c] / area_s(i, j)``. The gradient is
constant over each of the forward's cells, so a block stages the 50 small
bin gradients once, forms the cell vectors of one row segment from them and
stores each to every pixel of its cell with TMA bulk stores: bound by the
bytes of ``grad_x`` written. The JAX
package has no backward for its Pallas kernel; it differentiates XLA's
integral-image pool (``semseg_tpu/ops/pool.py:55``), which computes the
same sum. The pad-aware form is inference only (the JAX package trains on
unmasked canvases): with ``valid_hw``, an input that requires grad raises,
as does the pad-aware band form ``pyramid_pool_band``.

Each operator's CPU implementation is the plain version; its CUDA
implementation checks the inputs (raising, never copying), launches the
kernel and counts the launch. A tensor on any other device raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from semseg_tpu_torch.ops.dtypes import acc_dtype
from semseg_tpu_torch.ops.resize_dynamic import adaptive_avg_pool2d_valid, adaptive_pool_matrix

SCALES = (1, 2, 3, 6)
SOURCES = ("ppm_pool.cu",)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches made by the operators' CUDA implementations, eager or
#: from an exported program (an export trace launches nothing): the dense
#: form, the pad-aware form (``valid_hw`` given), the band form, the
#: dense form's backward and the band backward.
LAUNCHES = 0
VALID_LAUNCHES = 0
BAND_LAUNCHES = 0
BACKWARD_LAUNCHES = 0
BAND_BACKWARD_LAUNCHES = 0
# Engines on several threads (``cli.eval --devices``) launch at once.
_COUNT_LOCK = threading.Lock()


def pyramid_pool_plain(x: torch.Tensor, scales: Sequence[int] = SCALES,
                       valid_hw: Optional[torch.Tensor] = None):
    """Four ``F.adaptive_avg_pool2d`` calls on (N, H, W, C) ``x``, in f32;
    with ``valid_hw``, four ``adaptive_avg_pool2d_valid`` calls."""
    if valid_hw is not None:
        return tuple(adaptive_avg_pool2d_valid(x, s, valid_hw).contiguous()
                     for s in scales)
    xf = x.permute(0, 3, 1, 2).to(acc_dtype(x.dtype))
    return tuple(
        F.adaptive_avg_pool2d(xf, s).permute(0, 2, 3, 1).to(x.dtype).contiguous()
        for s in scales
    )


def pyramid_pool_band_plain(x: torch.Tensor, valid_hw: torch.Tensor, row0: int,
                            h: int) -> torch.Tensor:
    """(N, 50, C) f32 sums of band ``x`` ((N, hb, W, C), rows ``[row0, row0
    + hb)`` of an ``h``-row map) over each bin's rows in the band, bins over
    the extents ``valid_hw`` (clamped to the map): the rows ``[row0, row0 +
    hb)`` of ``adaptive_pool_matrix``'s bins, as indicators, in two f32
    products (float64 for a float64 band)."""
    n, hb, w, _ = x.shape
    vh = valid_hw[:, 0].clamp(0, h)
    vw = valid_hw[:, 1].clamp(0, w)
    xf = x.to(acc_dtype(x.dtype))
    sums = []
    for s in SCALES:
        mh = (adaptive_pool_matrix(s, h, vh, device=x.device)[..., row0:row0 + hb] > 0)
        mw = adaptive_pool_matrix(s, w, vw, device=x.device) > 0
        p = torch.einsum("nik,nkwc->niwc", mh.to(xf.dtype), xf)
        sums.append(torch.einsum("njw,niwc->nijc", mw.to(xf.dtype), p).reshape(n, s * s, -1))
    return torch.cat(sums, dim=1).contiguous()


def band_sums_to_grids(sums: torch.Tensor, valid_hw: torch.Tensor, hw: Tuple[int, int],
                       dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
    """The four (N, s, s, C) grids in ``dtype`` from the bands' summed (N,
    50, C) f32 sums of an ``hw`` map: each bin's sum over its area within
    the extents ``valid_hw`` (clamped to the map, an area at least 1), on
    the sums' device, with no host synchronisation."""
    n = sums.shape[0]
    vh = valid_hw[:, 0].clamp(0, hw[0]).to(torch.int64)
    vw = valid_hw[:, 1].clamp(0, hw[1]).to(torch.int64)
    grids, k = [], 0
    for s in SCALES:
        i = torch.arange(s, device=sums.device)

        def extent(v):  # (N, s) bin lengths over extents v
            v = v.view(-1, 1)
            return (((i + 1) * v + s - 1) // s - (i * v) // s).to(torch.float32)

        area = (extent(vh)[:, :, None] * extent(vw)[:, None, :]).clamp(min=1.0)
        mean = sums[:, k:k + s * s].view(n, s, s, -1) / area[..., None]
        grids.append(mean.to(dtype).contiguous())
        k += s * s
    return tuple(grids)


def bin_bounds(i: int, size: int, s: int) -> Tuple[int, int]:
    """Bin ``i`` of ``s`` over ``size``: ``[floor(i*size/s), ceil((i+1)*size/s))``."""
    return (i * size) // s, -(-((i + 1) * size) // s)


def pyramid_pool_backward_plain(grads: Sequence[torch.Tensor], hw: Tuple[int, int]):
    """The input gradient of the dense form, summed explicitly in f32 over
    the scales and each scale's bins (i, j) in order, rounded once to the
    gradients' dtype: (N, H, W, C) from the four (N, s, s, C) ``grads``."""
    return pyramid_pool_band_backward_plain(grads, 0, hw[0], hw)


def pyramid_pool_band_backward_plain(grads: Sequence[torch.Tensor], row0: int, hb: int,
                                     hw: Tuple[int, int]):
    """Rows ``[row0, row0 + hb)`` of ``pyramid_pool_backward_plain``'s
    gradient of an ``hw`` map, (N, hb, W, C): each bin's term over its rows
    in the band, added in the same order, so bit-equal to those rows."""
    h, w = hw
    n, _, _, c = grads[0].shape
    acc = torch.zeros((n, hb, w, c), dtype=acc_dtype(grads[0].dtype), device=grads[0].device)
    for s, g in zip(SCALES, grads):
        g = g.to(acc.dtype)
        for i in range(s):
            h0, h1 = bin_bounds(i, h, s)
            a, b = max(h0, row0), min(h1, row0 + hb)
            if a >= b:
                continue
            for j in range(s):
                w0, w1 = bin_bounds(j, w, s)
                term = g[:, i, j, :] / ((h1 - h0) * (w1 - w0))
                acc[:, a - row0:b - row0, w0:w1, :] += term[:, None, None, :]
    return acc.to(grads[0].dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with its C signatures declared (pointers and the
    stream as c_void_p, so that ctypes does not cut them to 32 bits)."""
    from semseg_tpu_torch.ops.kernels._build import load_library

    return declare(load_library("ppm_pool", SOURCES))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C signatures of a library built from a ``ppm_pool.cu``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ppm_pool_launch.argtypes = [vp] * 7 + [ci] * 5 + [vp]
    lib.ppm_pool_launch.restype = ci
    lib.ppm_pool_scratch_floats.argtypes = [ci] * 4
    lib.ppm_pool_scratch_floats.restype = ctypes.c_longlong
    if hasattr(lib, "ppm_pool_backward_launch"):  # an older source has none
        lib.ppm_pool_backward_launch.argtypes = [vp] * 5 + [ci] * 5 + [vp]
        lib.ppm_pool_backward_launch.restype = ci
    if hasattr(lib, "ppm_pool_band_backward_launch"):
        lib.ppm_pool_band_backward_launch.argtypes = [vp] * 5 + [ci] * 7 + [vp]
        lib.ppm_pool_band_backward_launch.restype = ci
    if hasattr(lib, "ppm_pool_band_launch"):
        # An older source's band form also takes a scratch pointer.
        lib.band_scratch = not hasattr(lib, "ppm_pool_band_abi")
        lib.ppm_pool_band_launch.argtypes = [vp] * (4 if lib.band_scratch else 3) + [ci] * 7 + [vp]
        lib.ppm_pool_band_launch.restype = ci
    return lib


def launch(lib: ctypes.CDLL, x: torch.Tensor,
           valid_hw: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """One launch of ``lib``'s kernel on checked CUDA inputs, uncounted.

    ``pyramid_pool`` calls it with the built library; a timing run may call
    it with a library built from another version of the source.
    """
    n, h, w, c = x.shape
    outs = [torch.empty((n, s, s, c), dtype=x.dtype, device=x.device) for s in SCALES]
    scratch = torch.empty(
        int(lib.ppm_pool_scratch_floats(n, h, w, c)),
        dtype=torch.float32, device=x.device,
    )
    with torch.cuda.device(x.device):
        err = lib.ppm_pool_launch(
            x.data_ptr(), *(o.data_ptr() for o in outs), scratch.data_ptr(),
            None if valid_hw is None else valid_hw.data_ptr(),
            n, h, w, c, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ppm_pool kernel launch failed: cudaError {err}")
    return tuple(outs)


def launch_band(lib: ctypes.CDLL, x: torch.Tensor, valid_hw: torch.Tensor, row0: int,
                h: int) -> torch.Tensor:
    """One launch of ``lib``'s band form on checked CUDA inputs, uncounted;
    returns the (N, 50, C) f32 sums, the only tensor it allocates (a library
    built from an older source also gets its scratch)."""
    n, hb, w, c = x.shape
    sums = torch.empty((n, 50, c), dtype=torch.float32, device=x.device)
    scratch = [torch.empty(int(lib.ppm_pool_scratch_floats(n, h, w, c)),
                           dtype=torch.float32, device=x.device)] if lib.band_scratch else []
    with torch.cuda.device(x.device):
        err = lib.ppm_pool_band_launch(
            x.data_ptr(), sums.data_ptr(), *(t.data_ptr() for t in scratch), valid_hw.data_ptr(),
            n, hb, w, c, h, row0, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ppm_pool band kernel launch failed: cudaError {err}")
    return sums


def launch_backward(lib: ctypes.CDLL, grads: Sequence[torch.Tensor],
                    hw: Tuple[int, int]) -> torch.Tensor:
    """One launch of ``lib``'s backward kernel on checked, contiguous CUDA
    gradients, uncounted; returns the (N, H, W, C) input gradient."""
    g = grads[0]
    n, _, _, c = g.shape
    out = torch.empty((n, *hw, c), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        err = lib.ppm_pool_backward_launch(
            *(t.data_ptr() for t in grads), out.data_ptr(), n, hw[0], hw[1], c,
            _DTYPE_CODES[g.dtype], torch.cuda.current_stream(g.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ppm_pool backward kernel launch failed: cudaError {err}")
    return out


def launch_band_backward(lib: ctypes.CDLL, grads: Sequence[torch.Tensor], row0: int, hb: int,
                         hw: Tuple[int, int]) -> torch.Tensor:
    """One launch of ``lib``'s band backward on checked, contiguous CUDA
    gradients, uncounted; returns rows ``[row0, row0 + hb)`` of the input
    gradient, (N, hb, W, C)."""
    g = grads[0]
    n, _, _, c = g.shape
    out = torch.empty((n, hb, hw[1], c), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        err = lib.ppm_pool_band_backward_launch(
            *(t.data_ptr() for t in grads), out.data_ptr(), n, hw[0], hw[1], c, row0, hb,
            _DTYPE_CODES[g.dtype], torch.cuda.current_stream(g.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ppm_pool band backward kernel launch failed: cudaError {err}")
    return out


def _check(x: torch.Tensor, valid_hw: Optional[torch.Tensor] = None) -> None:
    """What the kernel takes: raises on anything else, copies nothing."""
    if x.dim() != 4:
        raise ValueError(f"pyramid_pool expects (N, H, W, C), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"pyramid_pool takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(
            "pyramid_pool needs an NHWC-contiguous map (a channels_last "
            f"tensor permuted to NHWC); got strides {x.stride()}"
        )
    n, h, w, c = x.shape
    if max(n, h, w, c) >= 2**31:
        raise ValueError(f"pyramid_pool: dimension too large in {tuple(x.shape)}")
    if valid_hw is not None and (
        valid_hw.device != x.device or valid_hw.dtype != torch.int32
        or tuple(valid_hw.shape) != (n, 2) or not valid_hw.is_contiguous()
    ):
        raise ValueError(
            f"pyramid_pool: valid_hw must be a contiguous ({n}, 2) int32 tensor "
            f"on {x.device}; got {tuple(valid_hw.shape)} {valid_hw.dtype} on "
            f"{valid_hw.device}"
        )


def _check_band(x: torch.Tensor, valid_hw: torch.Tensor, row0: int, h: int) -> None:
    _check(x, valid_hw)
    hb = x.shape[1]
    if hb < 1 or row0 < 0 or row0 + hb > h or h >= 2**31:
        raise ValueError(f"pyramid_pool_band: rows [{row0}, {row0 + hb}) are not a "
                         f"non-empty band of a {h}-row map")


def _check_grads(grads: Sequence[torch.Tensor]) -> None:
    g = grads[0]
    n, _, _, c = g.shape
    for s, t in zip(SCALES, grads):
        if (tuple(t.shape) != (n, s, s, c) or t.dtype != g.dtype or t.device != g.device
                or not t.is_contiguous()):
            raise ValueError(
                f"pyramid_pool_backward: gradient {s} must be a contiguous ({n}, {s}, {s}, "
                f"{c}) {g.dtype} tensor on {g.device}; got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}, strides {t.stride()}"
            )
    if g.dtype not in _DTYPE_CODES:
        raise TypeError(f"pyramid_pool_backward takes float32 or bfloat16, got {g.dtype}")


def _check_band_grads(grads: Sequence[torch.Tensor], row0: int, hb: int, h: int,
                      w: int) -> None:
    _check_grads(grads)
    if hb < 1 or row0 < 0 or row0 + hb > h or min(h, w) < 1 or max(h, w) >= 2**31:
        raise ValueError(f"pyramid_pool_band_backward: rows [{row0}, {row0 + hb}) are not a "
                         f"non-empty band of a {h}x{w} map")


def _grids_like(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    n, _, _, c = x.shape
    return tuple(x.new_empty((n, s, s, c)) for s in SCALES)


# The three forms as registered operators (see the module docstring).
@torch.library.custom_op("semseg_tpu_torch::pyramid_pool", mutates_args=(), device_types="cpu")
def _dense_op(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    return pyramid_pool_plain(x)


@_dense_op.register_kernel("cuda")
def _dense_cuda(x):
    global LAUNCHES
    _check(x)
    outs = launch(_lib(), x)
    with _COUNT_LOCK:
        LAUNCHES += 1
    return outs


@torch.library.custom_op("semseg_tpu_torch::pyramid_pool_valid", mutates_args=(),
                         device_types="cpu")
def _valid_op(x: torch.Tensor, valid_hw: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    return pyramid_pool_plain(x, SCALES, valid_hw)


@_valid_op.register_kernel("cuda")
def _valid_cuda(x, valid_hw):
    global VALID_LAUNCHES
    _check(x, valid_hw)
    outs = launch(_lib(), x, valid_hw)
    with _COUNT_LOCK:
        VALID_LAUNCHES += 1
    return outs


@torch.library.custom_op("semseg_tpu_torch::pyramid_pool_band", mutates_args=(),
                         device_types="cpu")
def _band_op(x: torch.Tensor, valid_hw: torch.Tensor, row0: int, h: int) -> torch.Tensor:
    return pyramid_pool_band_plain(x, valid_hw, row0, h)


@_band_op.register_kernel("cuda")
def _band_cuda(x, valid_hw, row0, h):
    global BAND_LAUNCHES
    _check_band(x, valid_hw, row0, h)
    sums = launch_band(_lib(), x, valid_hw, row0, h)
    with _COUNT_LOCK:
        BAND_LAUNCHES += 1
    return sums


@torch.library.custom_op("semseg_tpu_torch::pyramid_pool_backward", mutates_args=(),
                         device_types="cpu")
def _backward_op(grads: List[torch.Tensor], h: int, w: int) -> torch.Tensor:
    return pyramid_pool_backward_plain(grads, (h, w))


@_backward_op.register_kernel("cuda")
def _backward_cuda(grads, h, w):
    global BACKWARD_LAUNCHES
    _check_grads(grads)
    out = launch_backward(_lib(), grads, (h, w))
    with _COUNT_LOCK:
        BACKWARD_LAUNCHES += 1
    return out


@torch.library.custom_op("semseg_tpu_torch::pyramid_pool_band_backward", mutates_args=(),
                         device_types="cpu")
def _band_backward_op(grads: List[torch.Tensor], row0: int, hb: int, h: int,
                      w: int) -> torch.Tensor:
    return pyramid_pool_band_backward_plain(grads, row0, hb, (h, w))


@_band_backward_op.register_kernel("cuda")
def _band_backward_cuda(grads, row0, hb, h, w):
    global BAND_BACKWARD_LAUNCHES
    _check_band_grads(grads, row0, hb, h, w)
    out = launch_band_backward(_lib(), grads, row0, hb, (h, w))
    with _COUNT_LOCK:
        BAND_BACKWARD_LAUNCHES += 1
    return out


_dense_op.register_fake(_grids_like)
_valid_op.register_fake(lambda x, valid_hw: _grids_like(x))
_band_op.register_fake(
    lambda x, valid_hw, row0, h: x.new_empty((x.shape[0], 50, x.shape[3]),
                                             dtype=acc_dtype(x.dtype)))


@_band_backward_op.register_fake
def _(grads, row0, hb, h, w):
    n, _, _, c = grads[0].shape
    return grads[0].new_empty((n, hb, w, c))


@_backward_op.register_fake
def _(grads, h, w):
    n, _, _, c = grads[0].shape
    return grads[0].new_empty((n, h, w, c))


def _setup_dense(ctx, inputs, output):
    ctx.hw = tuple(inputs[0].shape[1:3])


def _dense_backward(ctx, *grads):
    return _backward_op([g.contiguous() for g in grads], *ctx.hw)


_dense_op.register_autograd(_dense_backward, setup_context=_setup_dense)


def pyramid_pool(
    x: torch.Tensor, scales: Sequence[int] = SCALES,
    valid_hw: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """All adaptive-avg-pool grids of ``x`` (N, H, W, C), one read of ``x``.

    Returns a tuple of (N, s, s, C) tensors in ``x.dtype`` equal to
    ``adaptive_avg_pool2d`` at each scale, or with ``valid_hw`` ((N, 2)
    int32, each sample's extent, within the canvas) to
    ``adaptive_avg_pool2d_valid``. The dense form is differentiable (its
    backward is the second kernel); the pad-aware form raises if ``x``
    requires grad. On a CUDA tensor ``x`` must be float32 or bfloat16 and
    NHWC-contiguous (``permute(0, 2, 3, 1)`` of a channels_last map) and
    ``valid_hw`` a contiguous int32 tensor on the same card; the kernels run
    on the current stream and nothing is synchronised.
    """
    if tuple(scales) != SCALES:
        raise ValueError(f"pyramid_pool computes scales {SCALES}, got {tuple(scales)}")
    if valid_hw is not None and x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            "pyramid_pool: the pad-aware form (valid_hw) has no gradient; the "
            "training forward pools the whole canvas, as the JAX package does"
        )
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pyramid_pool: unsupported device {x.device}")
    return _dense_op(x) if valid_hw is None else _valid_op(x, valid_hw)


def pyramid_pool_band(x: torch.Tensor, valid_hw: torch.Tensor, row0: int,
                      h: int) -> torch.Tensor:
    """The band form: (N, 50, C) f32 sums of each bin's elements in rows
    ``[row0, row0 + hb)`` of an ``h``-row map, of which ``x`` (N, hb, W, C)
    holds those rows; bins over each sample's extent ``valid_hw`` ((N, 2)
    int32). ``band_sums_to_grids`` turns the bands' summed sums into the
    four grids. Inference only (training pools through
    ``pyramid_pool_bands``). On a CUDA tensor ``x`` must be float32 or
    bfloat16 and NHWC-contiguous, and ``valid_hw`` a contiguous int32
    tensor on the same card; the kernel runs on the current stream and
    nothing is synchronised.
    """
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("pyramid_pool_band has no gradient (inference only; training "
                           "pools its bands through pyramid_pool_bands)")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pyramid_pool_band: unsupported device {x.device}")
    return _band_op(x, valid_hw, int(row0), int(h))


def _full_extents(n: int, h: int, w: int, device) -> torch.Tensor:
    """(N, 2) int32 extents (h, w) on ``device``, made there (no copy from
    the host)."""
    v = torch.full((n, 2), h, dtype=torch.int32, device=device)
    v[:, 1] = w
    return v


class _BandedPool(torch.autograd.Function):
    """The four grids of a map held as row bands, over the whole map (see
    the module docstring); the gradient of each band is its rows of the
    dense backward."""

    @staticmethod
    def forward(ctx, *parts):
        h, w = sum(p.shape[1] for p in parts), parts[0].shape[2]
        n, dev0 = parts[0].shape[0], parts[0].device
        total, rows, row0 = None, [], 0
        for p in parts:
            v = _full_extents(n, h, w, p.device)
            sums = _band_op(p, v, row0, h).to(dev0, non_blocking=True)
            total = sums if total is None else total + sums
            rows.append((row0, p.shape[1], p.device))
            row0 += p.shape[1]
        ctx.rows, ctx.hw = rows, (h, w)
        return band_sums_to_grids(total, _full_extents(n, h, w, dev0), (h, w), parts[0].dtype)

    @staticmethod
    def backward(ctx, *grads):
        grads = [g.contiguous() for g in grads]
        return tuple(
            _band_backward_op([g.to(device, non_blocking=True) for g in grads], row0, hb,
                              *ctx.hw)
            for row0, hb, device in ctx.rows)


def pyramid_pool_bands(parts: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The four (N, s, s, C) grids of an (N, H, W, C) map held as row bands
    ``parts`` (each NHWC-contiguous, in order, on its band's device; H the
    sum of their heights), over the whole map, on the first band's device:
    the dense form's result up to the order of the sums. Differentiable:
    each band's gradient is its rows of the dense backward
    (``pyramid_pool_band_backward``, launched on the band's device). On
    CUDA tensors each band must be float32 or bfloat16.
    """
    for p in parts:
        if p.device.type not in ("cpu", "cuda"):
            raise ValueError(f"pyramid_pool_bands: unsupported device {p.device}")
    return _BandedPool.apply(*parts)
