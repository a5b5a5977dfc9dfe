"""Batch norm in inference with its residual add and activation: one
hand-written CUDA kernel and its plain version.

``bn_act(x, weight, bias, running_mean, running_var, eps, residual, act)``
is ``act(batch_norm_inference(x, ...) + residual)`` (``ops/norm.py``;
``residual`` and ``act`` optional, ``act`` None, ``"relu"`` or
``"relu6"``). On the card the kernel (``csrc/bn_act.cu``) reads the map
(and the residual) once and writes the output once, folding the running
statistics into the affine in registers on every call, so nothing cached
can go stale after a load or a training step. Its arithmetic is the plain
chain's, op for op and rounding for rounding, so its outputs are bit-equal
to the plain version's on the card. It replaces no TPU kernel: the JAX
package leaves batch norm to XLA, which fuses it into the convolution.

On the card the kernel takes a float32 or bfloat16 map dense in
channels_last (the layout in which the port's models and engines hold
every map), float32 (C,) parameters on its card and a residual of its
shape, dtype and layout; the wrapper raises for any other CUDA input, as
the pool's wrappers do, and never falls back to the plain ops there. A
call whose output needs a gradient (eval-mode BNs in a training step,
``TRAIN.fix_bn``) runs the kernel forward through the operator, whose
backward (``register_autograd``) is the plain chain's gradient op for op,
so bit-equal to it. CPU tensors take the plain version.

The operator ``semseg_tpu_torch::bn_act`` (``torch.library.custom_op``) is
what ``torch.export`` records: its CPU implementation is the plain
version, its CUDA implementation the kernel, and a fake implementation
gives the output's shape and memory format, so an exported program keeps
one node per batch norm and launches the kernel (``serving.py``). An eager
call on plain CUDA tensors without a gradient skips the dispatcher and
launches directly: the operator's dispatch costs several times the launch
on the host, and eval is partly bound by the host.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from semseg_tpu_torch.ops.dtypes import acc_dtype
from semseg_tpu_torch.ops.norm import batch_norm_inference

SOURCES = ("bn_act.cu",)
ACTS = {"relu": F.relu, "relu6": F.relu6}
_ACT_CODES = {None: 0, "none": 0, "relu": 1, "relu6": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches (a call on an empty map launches nothing and is not
#: counted).
LAUNCHES = 0
# Engines on several threads (``cli.eval --devices``) call at once.
_COUNT_LOCK = threading.Lock()


def apply_act(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """``x`` through the activation ``act`` (None: unchanged)."""
    if act is None or act == "none":
        return x
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    return ACTS[act](x)


def bn_act_plain(x, weight, bias, running_mean, running_var, eps=1e-5,
                 residual: Optional[torch.Tensor] = None, act: Optional[str] = None):
    """``batch_norm_inference``, then ``+ residual`` and ``act``, as plain
    PyTorch ops."""
    y = batch_norm_inference(x, weight, bias, running_mean, running_var, eps=eps)
    if residual is not None:
        y = y + residual
    return apply_act(y, act)


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with its C signature declared (pointers and the
    stream as c_void_p, so that ctypes does not cut them to 32 bits)."""
    from semseg_tpu_torch.ops.kernels._build import load_library

    lib = load_library("bn_act", SOURCES)
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bn_act_launch.argtypes = [vp] * 7 + [ctypes.c_float, cll, ci, cll, ci, ci, ci, vp]
    lib.bn_act_launch.restype = ci
    return lib


def _check(x, weight, bias, running_mean, running_var, residual):
    """Raise unless the kernel takes these CUDA inputs."""
    if x.dim() != 4 or x.dtype not in _DTYPE_CODES \
            or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(
            "bn_act on the card takes a float32 or bfloat16 (N, C, H, W) map dense in "
            f"channels_last, got {x.dtype} {tuple(x.shape)} with strides {x.stride()}")
    # get_device() and the shapes compare without building torch.device
    # objects: this runs on every eval BN call.
    dev, vec = x.get_device(), (x.shape[1],)
    for name, t in zip(("weight", "bias", "running_mean", "running_var"),
                       (weight, bias, running_mean, running_var)):
        if t.dtype is not torch.float32 or t.get_device() != dev or t.shape != vec \
                or not t.is_contiguous():
            raise ValueError(f"bn_act: {name} must be a contiguous float32 {vec} tensor on "
                             f"the map's card, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if residual is not None and (
            residual.shape != x.shape or residual.dtype is not x.dtype
            or residual.get_device() != dev
            or not residual.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("bn_act: the residual must have the map's shape, dtype and card, "
                         "dense in channels_last")


def _cuda(x, weight, bias, running_mean, running_var, eps, residual, act):
    """One kernel launch, counted where the map is not empty: the output,
    the only tensor it allocates, on the current stream, with nothing
    synchronised."""
    global LAUNCHES
    _check(x, weight, bias, running_mean, running_var, residual)
    y = torch.empty_like(x)
    n, c, h, w = x.shape
    dev = x.get_device()
    err = _lib().bn_act_launch(
        x.data_ptr(), None if residual is None else residual.data_ptr(), y.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
        eps, n, c, h * w, _DTYPE_CODES[x.dtype], _ACT_CODES[act], dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"bn_act kernel launch failed: cudaError {err}")
    if y.numel():
        with _COUNT_LOCK:
            LAUNCHES += 1
    return y


@torch.library.custom_op("semseg_tpu_torch::bn_act", mutates_args=(), device_types="cpu")
def _op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
        running_var: torch.Tensor, eps: float, residual: Optional[torch.Tensor],
        act: str) -> torch.Tensor:
    return bn_act_plain(x, weight, bias, running_mean, running_var, eps, residual, act)


_op.register_kernel("cuda")(_cuda)


def _setup_context(ctx, inputs, output):
    x, weight, bias, running_mean, running_var, eps, residual, act = inputs
    ctx.eps, ctx.act, ctx.residual = eps, act, residual is not None
    ctx.save_for_backward(x, None if act == "none" else output, weight, running_mean,
                          running_var)


def _backward(ctx, grad):
    """The gradient autograd takes through ``bn_act_plain``, op for op (so
    bit-equal to it): the activation's backward from the output (ReLU6 is
    hardtanh(0, 6), whose input lies outside (0, 6) exactly where its
    output does), the residual's share, the cast to the accumulation
    dtype, the affine's products with their broadcast sums, and the fold
    from the (C,) vectors. The running statistics take no gradient."""
    x, out, weight, running_mean, running_var = ctx.saved_tensors
    need = ctx.needs_input_grad
    if need[3] or need[4]:
        raise RuntimeError("bn_act: the running statistics take no gradient")
    if ctx.act == "relu":
        grad = torch.ops.aten.threshold_backward(grad, out, 0)
    elif ctx.act == "relu6":
        grad = torch.ops.aten.hardtanh_backward(grad, out, 0.0, 6.0)
    adt = acc_dtype(x.dtype)
    g = grad.to(adt)
    inv = torch.rsqrt(running_var + ctx.eps)
    grad_x = grad_weight = grad_bias = None
    if need[0]:
        grad_x = (g * (weight * inv).to(adt).view(1, -1, 1, 1)).to(x.dtype)
    if need[1] or need[2]:
        grad_bias = g.sum_to_size(1, x.shape[1], 1, 1).view(-1).to(weight.dtype)
    if need[1]:
        gw = (g * x.to(adt)).sum_to_size(1, x.shape[1], 1, 1).view(-1).to(weight.dtype)
        grad_weight = gw * inv + (-grad_bias * inv) * running_mean
    return (grad_x, grad_weight, grad_bias if need[2] else None, None, None, None,
            grad if ctx.residual and need[6] else None, None)


_op.register_autograd(_backward, setup_context=_setup_context)


@_op.register_fake
def _(x, weight, bias, running_mean, running_var, eps, residual, act):
    return torch.empty_like(x)


def bn_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           running_mean: torch.Tensor, running_var: torch.Tensor, eps: float = 1e-5,
           residual: Optional[torch.Tensor] = None, act: Optional[str] = None) -> torch.Tensor:
    """``act(batch_norm_inference(x, ...) + residual)`` over the channels of
    (N, C, H, W) ``x`` (module docstring): on the card one kernel launch,
    on the current stream, with nothing synchronised; ``ValueError`` for
    CUDA inputs it does not take."""
    if act not in _ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    if type(x) is torch.Tensor and not torch.compiler.is_compiling():
        if not x.is_cuda:
            return bn_act_plain(x, weight, bias, running_mean, running_var, eps, residual, act)
        if not torch.is_grad_enabled() or not (
                x.requires_grad or weight.requires_grad or bias.requires_grad
                or (residual is not None and residual.requires_grad)):
            return _cuda(x, weight, bias, running_mean, running_var, eps, residual, act)
    # Traced (torch.export, torch.compile), or on the card under a gradient:
    # the operator (the kernel forward and its backward).
    return _op(x, weight, bias, running_mean, running_var, float(eps), residual, act or "none")
