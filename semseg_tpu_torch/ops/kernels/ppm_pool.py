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

``pyramid_pool`` takes the plain version only for a tensor on the CPU. For a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from semseg_tpu_torch.ops.dtypes import acc_dtype
from semseg_tpu_torch.ops.resize_dynamic import adaptive_avg_pool2d_valid

SCALES = (1, 2, 3, 6)
SOURCES = ("ppm_pool.cu",)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches made by ``pyramid_pool`` (CUDA tensors only): the dense
#: form, and the pad-aware form (``valid_hw`` given).
LAUNCHES = 0
VALID_LAUNCHES = 0


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


def pyramid_pool(
    x: torch.Tensor, scales: Sequence[int] = SCALES,
    valid_hw: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """All adaptive-avg-pool grids of ``x`` (N, H, W, C), one read of ``x``.

    Returns a tuple of (N, s, s, C) tensors in ``x.dtype`` equal to
    ``adaptive_avg_pool2d`` at each scale, or with ``valid_hw`` ((N, 2)
    int32, each sample's extent, within the canvas) to
    ``adaptive_avg_pool2d_valid``. On a CUDA tensor ``x`` must be float32
    or bfloat16 and NHWC-contiguous (``permute(0, 2, 3, 1)`` of a
    channels_last map) and ``valid_hw`` a contiguous int32 tensor on the
    same card; the kernel runs on the current stream and nothing is
    synchronised.
    """
    global LAUNCHES, VALID_LAUNCHES
    if tuple(scales) != SCALES:
        raise ValueError(f"pyramid_pool computes scales {SCALES}, got {tuple(scales)}")
    if x.device.type == "cpu":
        return pyramid_pool_plain(x, scales, valid_hw)
    if x.device.type != "cuda":
        raise ValueError(f"pyramid_pool: unsupported device {x.device}")
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
    outs = launch(_lib(), x, valid_hw)
    if valid_hw is None:
        LAUNCHES += 1
    else:
        VALID_LAUNCHES += 1
    return outs
