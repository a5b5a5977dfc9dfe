"""The height split's pieces (``semseg_tpu_torch/parallel/spatial.py``) on
the CPU, each against its whole-map op, in float32.

* ``BandPlan``: near-equal contiguous bands of the stride-8 rows, the
  empty ones last and skipped, each stride's rows covering its level.
* ``band_resize`` (a banded map resized onto a finer stride's rows) against
  the whole map's ``resize_bilinear``, at 2x, 4x and 8x, in float32 (atol
  1e-5) and float64 (and its gradient, 1e-12), over plans whose bands are
  one row thick at the coarse stride and over canvases that are not a
  multiple of 32;
* each banded conv and the max pool against the op on the whole map, for
  (k, s, p, d) in {(3,1,1,1), (3,2,1,1), (3,1,2,2), (3,1,4,4), (1,2,0,1)}
  and grouped and depthwise convs, over splits whose bands are a row thick
  (so a halo spans several bands): atol 1e-6;
* the pool's band form (``pyramid_pool_band_plain``) summed over random
  splits and divided by the bin areas (``band_sums_to_grids``) against the
  pad-aware form (``pyramid_pool_plain(valid_hw=...)``): atol 1e-6;
* the summed bands held directly against JAX's ``adaptive_avg_pool2d_valid``
  (``semseg_tpu/ops/resize_dynamic.py:70``) times the bin areas, over
  ``BandPlan`` cuts and over one-row bands at every segment boundary:
  within 1e-6 of the largest sum (JAX's f32 means carry ~4e-7 of relative
  rounding into the product);
* ``upsample_grid_valid`` over a band's rows bit-equal to those rows of the
  whole map's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semseg_tpu.ops.resize_dynamic import adaptive_avg_pool2d_valid

from semseg_tpu_torch.models.layers import Conv2d
from semseg_tpu_torch.ops.kernels import ppm_pool
from semseg_tpu_torch.ops.pool import max_pool2d
from semseg_tpu_torch.ops.resize import resize_bilinear
from semseg_tpu_torch.ops.resize_dynamic import upsample_grid_valid
from semseg_tpu_torch.parallel.spatial import (
    BandPlan,
    band_conv,
    band_max_pool,
    band_resize,
    gather,
    run_banded,
    split_rows,
)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("hp", [40, 48, 64, 96, 600])
def test_band_plan(hp, n):
    """The default base-8 plan (the dilated encoders') and a base-32 plan
    (the non-dilated ResNets' and HRNetV2's), which serves strides 16 and
    32 too; a stride beyond the base, or not a power of two, is refused."""
    assert BandPlan(hp, n).spans == BandPlan(hp, n, base=8).spans
    for base in (8, 32):
        plan = BandPlan(hp, n, base=base)
        rows_base = -(-hp // base)
        sizes = [b - a for a, b in plan.spans]
        assert plan.count == min(n, rows_base) and min(sizes) >= 1
        assert max(sizes) - min(sizes) <= 1
        assert sizes == sorted(sizes, reverse=True)  # the longer bands first
        strides = [2 ** k for k in range(base.bit_length())]
        for stride in strides:
            rows = plan.rows(stride)
            assert rows[0][0] == 0 and rows[-1][1] == plan.height(stride) == -(-hp // stride)
            assert all(r1 == q0 for (_, r1), (q0, _) in zip(rows, rows[1:]))  # contiguous
            assert all(r1 > r0 for r0, r1 in rows)
            k = base // stride
            assert [r0 for r0, _ in rows] == [a * k for a, _ in plan.spans]
        for bad in (2 * base, 3):
            with pytest.raises(NotImplementedError, match=f"base {base}"):
                plan.rows(bad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("factor", [2, 4, 8])
@pytest.mark.parametrize("hp,n", [(128, 4), (600, 3), (100, 4), (64, 2)])
def test_band_resize_matches_whole_map(hp, n, factor, dtype):
    plan = BandPlan(hp, n, base=32)
    src, dst = 32, 32 // factor
    rng = np.random.RandomState(hp + n + factor)
    x = torch.tensor(rng.randn(2, 5, plan.height(src), 7), dtype=dtype,
                     requires_grad=True)
    width = -(-7 * factor // 1) - 3  # not an exact multiple, as a canvas's may be
    whole = resize_bilinear(x, (plan.height(dst), width))
    bands = band_resize(split_rows(x, plan, ["cpu"] * n, src), dst, width)
    assert bands.stride == dst and [p.shape[2] for p in bands.parts] == [
        r1 - r0 for r0, r1 in plan.rows(dst)]
    out = gather(bands, "cpu")
    # In float32 a weight carries the rounding of its source row's
    # coordinate, up to ~2e-6 for a 19-row map, times the rows' difference.
    tol = dict(atol=1e-12, rtol=0) if dtype == torch.float64 else dict(atol=1e-5, rtol=0)
    torch.testing.assert_close(out, whole, **tol)
    assert band_resize(bands, dst, width) is bands  # same stride: the map itself
    if dtype == torch.float64:
        g = torch.tensor(rng.randn(*whole.shape), dtype=dtype)
        (grad,) = torch.autograd.grad(out, x, g)
        (ref,) = torch.autograd.grad(whole, x, g)
        torch.testing.assert_close(grad, ref, **tol)


def _map(shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(x).permute(0, 3, 1, 2)  # NCHW, channels_last in memory


def _conv(cin, cout, k, s, p, d, groups, seed):
    conv = Conv2d(cin, cout, k, stride=s, padding=p, dilation=d, groups=groups, bias=True)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(rng.randn(*conv.weight.shape).astype(np.float32)))
        conv.bias.copy_(torch.from_numpy(rng.randn(cout).astype(np.float32)))
    return conv


# (k, s, p, d, groups); the stride of the map the op reads (a stride-2 op
# reads stride 1 or 4).
OPS = [(3, 1, 1, 1, 1, 8), (3, 2, 1, 1, 1, 1), (3, 1, 2, 2, 1, 8), (3, 1, 4, 4, 1, 8),
       (1, 2, 0, 1, 1, 4), (3, 1, 2, 2, 4, 8), (3, 2, 1, 1, 8, 4), (3, 1, 4, 4, 8, 8)]


@pytest.mark.parametrize("k,s,p,d,groups,stride", OPS)
@pytest.mark.parametrize("hp,n", [(64, 2), (64, 3), (40, 8), (96, 4)])
def test_band_conv_matches_whole_map(k, s, p, d, groups, stride, hp, n):
    plan = BandPlan(hp, n)
    c = 8
    x = _map((1, plan.height(stride), 13, c), seed=hp + n)
    conv = _conv(c, 8, k, s, p, d, groups, seed=k + s + p + d + groups)
    with torch.no_grad():
        out = gather(band_conv([conv] * plan.count, split_rows(x, plan, ["cpu"] * n, stride)),
                     "cpu")
        ref = conv(x)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("hp,n", [(64, 2), (48, 4), (40, 8), (600, 3)])
def test_band_max_pool_matches_whole_map(hp, n):
    plan = BandPlan(hp, n)
    x = _map((1, plan.height(2), 11, 4), seed=n) - 3.0  # mostly negative: -inf padding shows
    out = gather(band_max_pool(split_rows(x, plan, ["cpu"] * n, 2), 3, 2, 1), "cpu")
    np.testing.assert_allclose(out.numpy(), max_pool2d(x, kernel_size=3, stride=2, padding=1)
                               .numpy(), atol=1e-6, rtol=0)


def test_run_banded_walks_a_sequential_and_refuses_other_modules():
    from semseg_tpu_torch.models.layers import BatchNorm2d, ConvBN

    plan = BandPlan(64, 3)
    block = ConvBN(8, 8, 3, dilation=2).eval()
    x = _map((1, 8, 9, 8), seed=3)
    bands = split_rows(x, plan, ["cpu"] * 3, 8)
    with torch.no_grad():
        out = gather(run_banded([block] * 3, bands), "cpu")
        np.testing.assert_allclose(out.numpy(), block(x).numpy(), atol=1e-6, rtol=0)
        with pytest.raises(NotImplementedError, match="AdaptiveAvgPool2d"):
            run_banded([torch.nn.AdaptiveAvgPool2d(2)] * 3, bands)
        with pytest.raises(RuntimeError, match="eval mode only"):
            run_banded([BatchNorm2d(8).train()] * 3, bands)


@pytest.mark.parametrize("shape,extents", [
    ((2, 75, 100, 16), [[75, 100], [37, 51]]),
    ((3, 13, 17, 5), [[13, 17], [1, 1], [0, 0]]),
    ((1, 38, 50, 8), [[38, 50]]),
])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_band_sums_over_random_splits_are_the_valid_form(shape, extents, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    v = torch.tensor(extents, dtype=torch.int32)
    h = shape[1]
    cuts = [0] + sorted(rng.choice(np.arange(1, h), min(h - 1, 1 + seed * 2),
                                   replace=False).tolist()) + [h]
    total = sum(ppm_pool.pyramid_pool_band_plain(x[:, a:b], v, a, h)
                for a, b in zip(cuts, cuts[1:]))
    grids = ppm_pool.band_sums_to_grids(total, v, (h, shape[2]), x.dtype)
    for g, r in zip(grids, ppm_pool.pyramid_pool_plain(x, valid_hw=v)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-6, rtol=0)
    # The wrapper's CPU path is the plain version and counts no launch.
    before = ppm_pool.BAND_LAUNCHES
    band = ppm_pool.pyramid_pool_band(x[:, cuts[0]:cuts[1]].contiguous(), v, 0, h)
    torch.testing.assert_close(band, ppm_pool.pyramid_pool_band_plain(x[:, :cuts[1]], v, 0, h),
                               rtol=0, atol=0)
    assert ppm_pool.BAND_LAUNCHES == before


def _jax_band_sums(x, extents):
    """(N, 50, C) bin sums from JAX's pad-aware means times the bin areas
    over each extent (clamped to the map, an area at least 1), in float64."""
    n, h, w, c = x.shape
    v = np.clip(np.asarray(extents), 0, [h, w])
    sums = []
    for s in ppm_pool.SCALES:
        mean = np.asarray(adaptive_avg_pool2d_valid(
            jnp.asarray(x), s, jnp.asarray(np.asarray(extents, np.int32))), np.float64)
        i = np.arange(s)

        def lengths(e):  # (N, s) bin lengths over extents e
            return ((i + 1) * e[:, None] + s - 1) // s - (i * e[:, None]) // s

        area = np.maximum(lengths(v[:, 0])[:, :, None] * lengths(v[:, 1])[:, None, :], 1)
        sums.append((mean * area[..., None]).reshape(n, s * s, c))
    return np.concatenate(sums, axis=1)


def _boundary_bands(h):
    """Row cuts of an h-row map with a one-row band at every boundary of its
    segments (the starts and ends of its six scale-6 bins)."""
    bounds = {(i * h) // 6 for i in range(6)} | {-(-((i + 1) * h) // 6) for i in range(6)}
    inside = {b for b in bounds if b < h}
    return sorted({0, h} | inside | {b + 1 for b in inside})


@pytest.mark.parametrize("shape,extents,cuts", [
    ((4, 75, 100, 6), [[75, 100], [37, 51], [75, 13], [0, 0]], BandPlan(600, 2).rows(8)),
    ((4, 75, 100, 6), [[75, 100], [37, 51], [75, 13], [0, 0]], BandPlan(600, 4).rows(8)),
    ((4, 75, 100, 6), [[75, 100], [37, 51], [75, 13], [0, 0]], BandPlan(600, 8).rows(8)),
    ((4, 75, 100, 6), [[75, 100], [61, 99], [2, 100], [13, 1]], _boundary_bands(75)),
    ((3, 40, 56, 6), [[40, 56], [23, 41], [1, 56]], _boundary_bands(40)),
], ids=["plan-2", "plan-4", "plan-8", "boundary-rows-75", "boundary-rows-40"])
def test_summed_band_sums_are_jax_valid_pool_times_areas(shape, extents, cuts):
    if isinstance(cuts[0], tuple):  # BandPlan rows: [(a, b), ...]
        cuts = [a for a, _ in cuts] + [cuts[-1][1]]
    assert cuts[0] == 0 and cuts[-1] == shape[1]
    x = np.random.RandomState(shape[1]).randn(*shape).astype(np.float32)
    v = torch.tensor(extents, dtype=torch.int32)
    total = sum(ppm_pool.pyramid_pool_band_plain(torch.from_numpy(x[:, a:b]), v, a, shape[1])
                for a, b in zip(cuts, cuts[1:]))
    ref = _jax_band_sums(x, extents)
    np.testing.assert_allclose(total.double().numpy(), ref, atol=1e-6 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("rows", [(0, 5), (5, 6), (6, 19), (0, 19)])
def test_upsample_grid_valid_rows_are_the_whole_maps(rows):
    rng = np.random.RandomState(4)
    v = torch.tensor([[19, 23], [11, 7]], dtype=torch.int32)
    for s in (1, 2, 3, 6):
        p = torch.from_numpy(rng.randn(2, s, s, 12).astype(np.float32))
        whole = upsample_grid_valid(p, (19, 23), v)
        band = upsample_grid_valid(p, (19, 23), v, rows)
        assert torch.equal(band, whole[:, rows[0]:rows[1]])
