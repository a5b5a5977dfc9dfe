"""The port's valid-size ops against the JAX package's, on the CPU.

``ops.preproc`` and ``ops.resize_dynamic`` of the port and of
``semseg_tpu.ops`` get the same seeded numpy inputs, at odd extents, full
extents and 1-pixel extents. Everything is float32 and held to atol 1e-6:
the formulas are the same float32 operations, and the products differ only
in summation order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semseg_tpu.ops import preproc as jpreproc, resize_dynamic as jrd
from semseg_tpu_torch.ops import preproc, resize_dynamic as rd

ATOL = 1e-6
EXTENTS = [[13, 17], [7, 9], [1, 1], [12, 5]]  # full, odd, 1x1, mixed


def _close(out, ref):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("batched", [False, True])
def test_normalize_u8_masked(batched):
    rng = np.random.RandomState(0)
    if batched:
        img = rng.randint(0, 256, (3, 16, 24, 3)).astype(np.uint8)
        h, w = np.array([16, 9, 1], np.int32), np.array([24, 13, 1], np.int32)
        out = preproc.normalize_u8_masked(torch.from_numpy(img), torch.from_numpy(h),
                                          torch.from_numpy(w))
    else:
        img = rng.randint(0, 256, (16, 24, 3)).astype(np.uint8)
        h, w = 11, 7
        out = preproc.normalize_u8_masked(torch.from_numpy(img), h, w)
    ref = jpreproc.normalize_u8_masked(jnp.asarray(img), jnp.asarray(h), jnp.asarray(w))
    assert out.dtype == torch.float32 and out.shape == img.shape
    _close(out, ref)


@pytest.mark.parametrize("out_pad,in_pad,out_valid,in_valid", [
    (24, 8, 24, 8), (24, 8, 19, 5), (40, 13, 33, 13), (8, 24, 7, 19), (6, 1, 6, 1),
])
def test_resize_matrix(out_pad, in_pad, out_valid, in_valid):
    _close(rd.resize_matrix(out_pad, in_pad, out_valid, in_valid),
           jrd.resize_matrix(out_pad, in_pad, out_valid, in_valid))


@pytest.mark.parametrize("grid", [1, 2, 3, 6])
@pytest.mark.parametrize("in_valid", [17, 13, 5, 1])
def test_adaptive_pool_matrix(grid, in_valid):
    _close(rd.adaptive_pool_matrix(grid, 17, in_valid),
           jrd.adaptive_pool_matrix(grid, 17, in_valid))


def test_matrices_take_a_batch_of_sizes():
    """A (N,) tensor of valid sizes gives the N matrices of its entries."""
    v = torch.tensor([13, 7, 1])
    batched = rd.adaptive_pool_matrix(3, 13, v)
    for n in range(3):
        torch.testing.assert_close(batched[n], rd.adaptive_pool_matrix(3, 13, int(v[n])),
                                   atol=0, rtol=0)
    batched = rd.resize_matrix(20, 6, v, 6)
    for n in range(3):
        torch.testing.assert_close(batched[n], rd.resize_matrix(20, 6, int(v[n]), 6),
                                   atol=0, rtol=0)


@pytest.mark.parametrize("s", [1, 2, 3, 6])
def test_adaptive_avg_pool2d_valid(s):
    x = np.random.RandomState(1).randn(4, 13, 17, 8).astype(np.float32)
    v = np.array(EXTENTS, np.int32)
    out = rd.adaptive_avg_pool2d_valid(torch.from_numpy(x), s, torch.from_numpy(v))
    assert out.shape == (4, s, s, 8)
    _close(out, jrd.adaptive_avg_pool2d_valid(jnp.asarray(x), s, jnp.asarray(v)))


@pytest.mark.parametrize("s", [1, 2, 3, 6])
def test_upsample_grid_valid(s):
    p = np.random.RandomState(2).randn(4, s, s, 8).astype(np.float32)
    v = np.array(EXTENTS, np.int32)
    out = rd.upsample_grid_valid(torch.from_numpy(p), (13, 17), torch.from_numpy(v))
    assert out.shape == (4, 13, 17, 8) and out.is_contiguous()
    _close(out, jrd.upsample_grid_valid(jnp.asarray(p), (13, 17), jnp.asarray(v)))
