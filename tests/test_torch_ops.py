"""The port's ops (semseg_tpu_torch.ops) against the JAX package's ops.

Inputs come from a seeded numpy generator and go through both; the port
works in NCHW, the JAX ops in NHWC. Everything is float32 on the CPU and
held to atol 1e-5: the two differ only in summation order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semseg_tpu import ops as jops
from semseg_tpu_torch import ops

ATOL = 1e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.numpy(), (0, 2, 3, 1))


@pytest.mark.parametrize("shape", [(2, 7, 9, 5), (1, 13, 17, 64)])
def test_batch_norm_inference(shape):
    rng = np.random.RandomState(0)
    c = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    w, b, rm = (rng.randn(c).astype(np.float32) for _ in range(3))
    rv = rng.rand(c).astype(np.float32) + 0.1
    ref = jops.batch_norm_inference(*(jnp.asarray(a) for a in (x, w, b, rm, rv)))
    out = ops.batch_norm_inference(_nchw(x), *(torch.from_numpy(a) for a in (w, b, rm, rv)))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(1, 13, 17, 4), (2, 8, 9, 3), (1, 1, 1, 2)])
def test_max_pool2d(shape):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    ref = jops.max_pool2d(jnp.asarray(x), kernel_size=3, stride=2, padding=1)
    out = ops.max_pool2d(_nchw(x), kernel_size=3, stride=2, padding=1)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("hw", [(13, 17), (75, 100), (5, 4), (1, 1)])
@pytest.mark.parametrize("s", [1, 2, 3, 6])
def test_adaptive_avg_pool2d(hw, s):
    """Odd sizes give overlapping bins; sizes below s repeat rows."""
    x = np.random.RandomState(2).randn(2, *hw, 8).astype(np.float32)
    ref = jops.adaptive_avg_pool2d(jnp.asarray(x), s)
    out = ops.adaptive_avg_pool2d(_nchw(x), s)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "src,dst",
    [((7, 9), (15, 20)), ((16, 20), (5, 7)), ((1, 1), (9, 11)), ((6, 6), (6, 6)),
     ((75, 100), (600, 800))],
    ids=["up", "down", "from-1x1", "same", "logits-to-label"],
)
def test_resize_bilinear(src, dst):
    x = np.random.RandomState(3).randn(1, *src, 6).astype(np.float32)
    ref = jops.resize_bilinear(jnp.asarray(x), dst)
    out = ops.resize_bilinear(_nchw(x), dst)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), atol=ATOL, rtol=0)
