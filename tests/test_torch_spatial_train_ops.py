"""The height split's training pieces on the CPU (``cli.train TPU.spatial``),
each against the unsplit op, in float64 where frameworks meet.

* the pool's band backward (``pyramid_pool_band_backward``): its plain
  version over ``BandPlan``'s 2 and 4 bands and over bands of one stride-8
  row, bit-equal to ``pyramid_pool_backward_plain``'s rows, and within
  1e-10 of ``jax.vjp`` of the JAX package's pool
  (``semseg_tpu/ops/pool.py:55``, XLA's integral image, which JAX
  differentiates under its hybrid mesh) over the whole map, sliced to the
  band; the registered operator passes ``torch.library.opcheck``;
* ``pyramid_pool_bands``, the differentiable banded pool: its grids
  against the dense form's (summation order, 1e-12 in float64) and its
  bands' gradients bit-equal to the dense form's rows, in float32 and
  float64; the pad-aware band form still refuses a gradient;
* a banded conv (one module for every band) against the unsplit conv:
  output, input gradient (a halo row's gradient returned to the band that
  sent it) and weight and bias gradients (summed over the bands), with
  dilation 4 over one-row bands, so that a halo spans four bands; the max
  pool's input gradient likewise;
* banded ``BatchNorm2d`` in training against the unsplit call: output,
  input gradient, the parameters' gradients, running statistics and
  ``iter`` (advanced once);
* ``Dropout2d`` over bands: one (N, C) mask for every band, equal to the
  unsplit call's;
* ``resize_bilinear_rows``, a band's rows of a pyramid grid's bilinear
  upsample, against the whole map's rows, value and gradient;
* ``split_labels``: the stride-8 rows of each band, and the stride-4 rows of
  a plan cut at stride 32;
* ``ordered_collectives``: each differentiable all-reduce made inside
  takes the previous one as an input, so the backward runs them in the
  reverse of the forward's order (autograd runs each card's part of the
  backward on its own thread; the chain keeps the ranks' collectives in
  one order).

Tolerances: 1e-12 absolute in float64 where only the order of sums
differs (measured below 1e-14), bit-equal where the terms and their order
are the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semseg_tpu.ops.pool import adaptive_avg_pool2d as jax_adaptive_avg_pool2d

from semseg_tpu_torch.models.layers import BatchNorm2d, Conv2d, Dropout2d
from semseg_tpu_torch.ops import norm
from semseg_tpu_torch.ops.kernels import ppm_pool
from semseg_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_rows
from semseg_tpu_torch.parallel.spatial import (
    BandPlan,
    band_apply,
    band_conv,
    band_max_pool,
    gather,
    split_labels,
    split_rows,
)

SCALES = ppm_pool.SCALES
TOL64 = dict(atol=1e-12, rtol=0)


def _cuts(h, bands):
    """Row cuts of an h-row map: ``bands`` BandPlan bands of its 8x canvas
    at stride 8, or one row a band (``bands`` 0)."""
    if bands == 0:
        return list(range(h + 1))
    return [0] + [b for _, b in BandPlan(8 * h, bands).rows(8)]


def _grads(n, c, seed, dtype=np.float64):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, s, s, c).astype(dtype) for s in SCALES]


@pytest.mark.parametrize("bands", [2, 4, 0], ids=["2_bands", "4_bands", "one_row_bands"])
def test_band_backward_plain_is_the_dense_rows_and_jax_vjp(bands):
    n, h, w, c = 2, 13, 17, 6
    grads = _grads(n, c, seed=1)
    tgrads = [torch.from_numpy(g) for g in grads]
    dense = ppm_pool.pyramid_pool_backward_plain(tgrads, (h, w))
    with jax.enable_x64(True):
        x = jnp.asarray(np.random.RandomState(2).randn(n, h, w, c))
        _, vjp = jax.vjp(lambda a: [jax_adaptive_avg_pool2d(a, s) for s in SCALES], x)
        (ref,) = vjp([jnp.asarray(g) for g in grads])
    ref = np.asarray(ref)
    cuts = _cuts(h, bands)
    for a, b in zip(cuts, cuts[1:]):
        band = ppm_pool.pyramid_pool_band_backward_plain(tgrads, a, b - a, (h, w))
        assert band.shape == (n, b - a, w, c) and band.dtype == torch.float64
        assert torch.equal(band, dense[:, a:b])
        np.testing.assert_allclose(band.numpy(), ref[:, a:b], atol=1e-10, rtol=0)
    # The operator (the CPU implementation is the plain version) agrees.
    a, b = cuts[1], cuts[2]
    op = torch.ops.semseg_tpu_torch.pyramid_pool_band_backward(tgrads, a, b - a, h, w)
    assert torch.equal(op, dense[:, a:b])


def test_band_backward_op_passes_opcheck():
    grads = [torch.from_numpy(g) for g in _grads(2, 24, seed=3, dtype=np.float32)]
    torch.library.opcheck(torch.ops.semseg_tpu_torch.pyramid_pool_band_backward,
                          (grads, 4, 5, 13, 17))


def test_cpu_band_backward_does_not_count_a_launch():
    before = ppm_pool.BAND_BACKWARD_LAUNCHES
    grads = [torch.from_numpy(g) for g in _grads(1, 8, seed=4)]
    ppm_pool.pyramid_pool_band_backward_plain(grads, 0, 3, (7, 9))
    torch.ops.semseg_tpu_torch.pyramid_pool_band_backward(grads, 2, 3, 7, 9)
    assert ppm_pool.BAND_BACKWARD_LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("cuts", [(0, 7, 13), (0, 1, 2, 3, 4, 13), (0, 4, 9, 12, 13)],
                         ids=["2_bands", "one_row_bands", "4_bands"])
def test_banded_pool_against_the_dense_form(cuts, dtype):
    n, h, w, c = 2, 13, 17, 8
    x = torch.from_numpy(np.random.RandomState(5).randn(n, h, w, c)).to(dtype)
    whole = x.clone().requires_grad_()
    parts = [x[:, a:b].clone().requires_grad_() for a, b in zip(cuts, cuts[1:])]
    grads = [torch.from_numpy(g).to(dtype) for g in _grads(n, c, seed=6)]
    dense = ppm_pool.pyramid_pool(whole)
    banded = ppm_pool.pyramid_pool_bands(parts)
    tol = TOL64 if dtype == torch.float64 else dict(atol=1e-6, rtol=0)
    for o, r in zip(banded, dense):
        assert o.shape == r.shape and o.dtype == dtype
        torch.testing.assert_close(o, r, **tol)
    torch.autograd.backward(dense, grads)
    torch.autograd.backward(banded, grads)
    # The same terms in the same order: each band's rows bit for bit.
    assert torch.equal(torch.cat([p.grad for p in parts], dim=1), whole.grad)


def test_pad_aware_band_form_still_refuses_a_gradient():
    x = torch.zeros(1, 4, 5, 8, requires_grad=True)
    v = torch.tensor([[8, 5]], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no gradient"):
        ppm_pool.pyramid_pool_band(x, v, 0, 8)


def _nchw(shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape)).permute(0, 3, 1, 2)


def _split(x, plan, n, stride=1):
    """``x`` cut in ``plan``'s bands, each a leaf that requires grad."""
    bands = split_rows(x, plan, ["cpu"] * n, stride)
    bands.parts = [p.detach().clone().requires_grad_() for p in bands.parts]
    return bands


# (k, s, p, d, groups, the map's stride, canvas rows): dilation 4 over
# bands of one stride-8 row (a halo spans four bands), a strided conv, a
# depthwise one.
CONVS = [(3, 1, 4, 4, 1, 8, 64), (3, 2, 1, 1, 1, 1, 40), (3, 1, 2, 2, 6, 4, 48)]


@pytest.mark.parametrize("k,s,p,d,groups,stride,hp", CONVS,
                         ids=["dilation4_one_row_bands", "stride2", "depthwise"])
def test_banded_conv_gradients(k, s, p, d, groups, stride, hp):
    n_bands = hp // 8
    plan = BandPlan(hp, n_bands)
    h = plan.height(stride)
    conv = Conv2d(6, 6, k, stride=s, padding=p, dilation=d, groups=groups, bias=True).double()
    x = _nchw((2, h, 11, 6), seed=7)
    whole = x.detach().clone().requires_grad_()
    ref = conv(whole)
    dy = _nchw(tuple(ref.permute(0, 2, 3, 1).shape), seed=8)
    (ref * dy).sum().backward()
    ref_w, ref_b = conv.weight.grad.clone(), conv.bias.grad.clone()
    conv.zero_grad()
    bands = _split(x, plan, n_bands, stride)
    out = band_conv([conv], bands)
    torch.testing.assert_close(gather(out, "cpu"), ref.detach(), **TOL64)
    rows = plan.rows(out.stride)
    sum((part * dy[:, :, r0:r1]).sum() for part, (r0, r1) in zip(out.parts, rows)).backward()
    torch.testing.assert_close(torch.cat([q.grad for q in bands.parts], dim=2), whole.grad,
                               **TOL64)
    torch.testing.assert_close(conv.weight.grad, ref_w, **TOL64)
    torch.testing.assert_close(conv.bias.grad, ref_b, **TOL64)


def test_banded_max_pool_gradient():
    plan = BandPlan(40, 5)
    x = _nchw((2, 20, 13, 4), seed=9)
    whole = x.detach().clone().requires_grad_()
    ref = torch.nn.functional.max_pool2d(whole, 3, 2, 1)
    dy = _nchw(tuple(ref.permute(0, 2, 3, 1).shape), seed=10)
    (ref * dy).sum().backward()
    bands = _split(x, plan, 5, stride=2)
    out = band_max_pool(bands, 3, 2, 1)
    rows = plan.rows(4)
    sum((q * dy[:, :, r0:r1]).sum() for q, (r0, r1) in zip(out.parts, rows)).backward()
    # A maximum of two windows takes their gradients in another order.
    torch.testing.assert_close(torch.cat([q.grad for q in bands.parts], dim=2), whole.grad,
                               **TOL64)


def test_banded_batch_norm_training():
    plan = BandPlan(48, 4)
    x = _nchw((2, 6, 5, 3), seed=11)
    rng = np.random.RandomState(12)
    results = []
    for banded in (False, True):
        bn = BatchNorm2d(3).double().train()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(rng.rand(3) + 0.5))
            bn.bias.copy_(torch.from_numpy(rng.randn(3)))
            bn.running_mean.copy_(torch.from_numpy(rng.randn(3)))
            bn.running_var.copy_(torch.from_numpy(rng.rand(3) + 0.5))
            bn._running_iter.fill_(1.999)
        dy = _nchw((2, 6, 5, 3), seed=13)
        if banded:
            bands = _split(x, plan, 4, stride=8)
            out = band_apply([bn], bands)
            y = gather(out, "cpu")
            (y * dy).sum().backward()
            dx = torch.cat([q.grad for q in bands.parts], dim=2)
        else:
            whole = x.detach().clone().requires_grad_()
            y = bn(whole)
            (y * dy).sum().backward()
            dx = whole.grad
        results.append((y.detach(), dx, bn.weight.grad, bn.bias.grad,
                        {k: v.clone() for k, v in bn.state_dict().items()}))
        rng = np.random.RandomState(12)
    for got, ref in zip(results[1][:4], results[0][:4]):
        torch.testing.assert_close(got, ref, **TOL64)
    for k, v in results[0][4].items():
        torch.testing.assert_close(results[1][4][k], v, **TOL64)
    # iter advanced once: 1.999 * 0.999 + 1.
    np.testing.assert_allclose(float(results[1][4]["_running_iter"]), 1.999 * 0.999 + 1,
                               rtol=1e-12)


def test_banded_batch_norm_rejects_one_element():
    bn = BatchNorm2d(3).train()
    with pytest.raises(ValueError, match=">1 element per channel, got 1"):
        bn.forward_bands([torch.zeros(1, 3, 1, 1)])


def test_training_copies_refuse_to_run_banded():
    """In training the bands share one module (``[module]``); per-band
    copies (eval's layout) would each take their own statistics."""
    plan = BandPlan(16, 2)
    bands = _split(_nchw((1, 2, 3, 4), seed=14), plan, 2, stride=8)
    with pytest.raises(RuntimeError, match="eval mode only"):
        band_apply([BatchNorm2d(4).train(), BatchNorm2d(4).train()], bands)


def test_dropout_draws_one_mask_for_every_band():
    plan = BandPlan(32, 4)
    x = torch.ones(2, 64, 4, 3, dtype=torch.float64)
    drop = Dropout2d(0.5).train()
    drop.generator = torch.Generator().manual_seed(3)
    ref = drop(x)
    drop.generator = torch.Generator().manual_seed(3)
    out = band_apply([drop], split_rows(x, plan, ["cpu"] * 4, 8))
    assert len(out.parts) == 4
    assert torch.equal(gather(out, "cpu"), ref)
    kept = ref[:, :, 0, 0] != 0
    assert 0 < int(kept.sum()) < kept.numel()
    for part in out.parts:  # each band keeps the same channels
        assert torch.equal(part[:, :, 0, 0] != 0, kept)


def test_split_labels():
    plan = BandPlan(40, 2)
    label = torch.arange(2 * 5 * 3, dtype=torch.int32).view(2, 5, 3)
    parts = split_labels(label, plan, ["cpu", "cpu"], 8)
    assert [p.shape[1] for p in parts] == [3, 2]
    assert torch.equal(torch.cat(parts, dim=1), label)
    with pytest.raises(ValueError, match="labels of 4 rows"):
        split_labels(label[:, :4], plan, ["cpu", "cpu"], 8)
    # Stride-4 labels (HRNetV2's and UPerNet's) on a plan cut at stride 32.
    plan = BandPlan(100, 3, base=32)
    label = torch.arange(2 * 25 * 3, dtype=torch.int32).view(2, 25, 3)
    parts = split_labels(label, plan, ["cpu"] * 3, 4)
    assert [p.shape[1] for p in parts] == [16, 8, 1]
    assert torch.equal(torch.cat(parts, dim=1), label)


def test_ordered_collectives_chain_the_all_reduces(monkeypatch):
    calls = []
    monkeypatch.setattr(norm.dist, "all_reduce", lambda t, group=None: calls.append(t.numel()))
    group = object()  # all_reduce_sum hands it to dist.all_reduce only
    x1, x2 = torch.ones(2, requires_grad=True), torch.ones(3, requires_grad=True)
    with norm.ordered_collectives():
        a = norm.all_reduce_sum(x1 * 2, group)
        b = norm.all_reduce_sum(x2 * 2, group)
        c = norm.all_reduce_sum(torch.ones(4), group)  # no gradient: not chained
    assert [f for f, _ in b.grad_fn.next_functions][1] is a.grad_fn
    assert len(a.grad_fn.next_functions) == 1 and c.grad_fn is None
    (a.sum() + b.sum()).backward()
    # Forward a, b, c; backward b, then a (after b, whatever else is ready).
    assert calls == [2, 3, 4, 3, 2]
    assert torch.equal(x1.grad, torch.full((2,), 2.0))
    # Outside the context nothing is chained.
    assert len(norm.all_reduce_sum(x1 * 2, group).grad_fn.next_functions) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("hw", [(56, 76), (13, 17), (4, 5)], ids=["56x76", "13x17", "4x5"])
def test_band_rows_of_the_bilinear_upsample(hw, dtype):
    """``resize_bilinear_rows`` (a band's rows of a pyramid grid's upsample
    in the banded PPM trunk) against the whole map's ``resize_bilinear``
    rows, over 2 bands and one-row bands: float64 to rounding (measured
    2e-15), float32 to one ulp of the values (1.1e-6); the gradient in
    float64 (in float32 a 1x1 grid's gradient sums 4,256 terms in another
    order)."""
    h, w = hw
    tol = TOL64 if dtype == torch.float64 else dict(atol=2e-6, rtol=1e-6)
    rng = np.random.RandomState(5)
    for s in SCALES:
        x = torch.tensor(rng.randn(2, 3, s, s), dtype=dtype, requires_grad=True)
        g = torch.tensor(rng.randn(2, 3, h, w), dtype=dtype)
        whole = resize_bilinear(x, hw)
        for cuts in ((0, h // 2, h), tuple(range(h + 1))):
            bands = [resize_bilinear_rows(x, hw, (a, b)) for a, b in zip(cuts, cuts[1:])]
            torch.testing.assert_close(torch.cat(bands, 2), whole.detach(), **tol)
            if dtype == torch.float64:
                (grad,) = torch.autograd.grad(bands, x, [g[:, :, a:b] for a, b in
                                                         zip(cuts, cuts[1:])])
                (ref_grad,) = torch.autograd.grad(whole, x, g, retain_graph=True)
                torch.testing.assert_close(grad, ref_grad, **TOL64)
