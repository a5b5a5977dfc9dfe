"""The height split's pieces (``semseg_tpu_torch/parallel/spatial.py``) on
the CPU, each against its whole-map op, in float32.

* ``BandPlan``: near-equal contiguous bands of the stride-8 rows, the
  empty ones last and skipped, each stride's rows covering its level.
* each banded conv and the max pool against the op on the whole map, for
  (k, s, p, d) in {(3,1,1,1), (3,2,1,1), (3,1,2,2), (3,1,4,4), (1,2,0,1)}
  and grouped and depthwise convs, over splits whose bands are a row thick
  (so a halo spans several bands): atol 1e-6;
* the pool's band form (``pyramid_pool_band_plain``) summed over random
  splits and divided by the bin areas (``band_sums_to_grids``) against the
  pad-aware form (``pyramid_pool_plain(valid_hw=...)``): atol 1e-6;
* ``upsample_grid_valid`` over a band's rows bit-equal to those rows of the
  whole map's.
"""

import numpy as np
import pytest
import torch

from semseg_tpu_torch.models.layers import Conv2d
from semseg_tpu_torch.ops.kernels import ppm_pool
from semseg_tpu_torch.ops.pool import max_pool2d
from semseg_tpu_torch.ops.resize_dynamic import upsample_grid_valid
from semseg_tpu_torch.parallel.spatial import (
    BandPlan,
    band_conv,
    band_max_pool,
    gather,
    run_banded,
    split_rows,
)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("hp", [40, 48, 64, 96, 600])
def test_band_plan(hp, n):
    plan = BandPlan(hp, n)
    rows8 = -(-hp // 8)
    sizes = [b - a for a, b in plan.spans]
    assert plan.count == min(n, rows8) and min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert sizes == sorted(sizes, reverse=True)  # the longer bands first
    for stride in (1, 2, 4, 8):
        rows = plan.rows(stride)
        assert rows[0][0] == 0 and rows[-1][1] == plan.height(stride) == -(-hp // stride)
        assert all(r1 == q0 for (_, r1), (q0, _) in zip(rows, rows[1:]))  # contiguous
        k = 8 // stride
        assert [r0 for r0, _ in rows] == [a * k for a, _ in plan.spans]
    with pytest.raises(NotImplementedError, match="item 17c"):
        plan.rows(16)


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


@pytest.mark.parametrize("rows", [(0, 5), (5, 6), (6, 19), (0, 19)])
def test_upsample_grid_valid_rows_are_the_whole_maps(rows):
    rng = np.random.RandomState(4)
    v = torch.tensor([[19, 23], [11, 7]], dtype=torch.int32)
    for s in (1, 2, 3, 6):
        p = torch.from_numpy(rng.randn(2, s, s, 12).astype(np.float32))
        whole = upsample_grid_valid(p, (19, 23), v)
        band = upsample_grid_valid(p, (19, 23), v, rows)
        assert torch.equal(band, whole[:, rows[0]:rows[1]])
