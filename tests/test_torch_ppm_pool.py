"""The port's pyramid pool against the JAX package's Pallas kernel.

On the CPU the port's ``pyramid_pool`` runs its plain version; it is held
against JAX ``pyramid_pool(..., interpret=True)`` and against four
``ops.adaptive_avg_pool2d`` calls. float32 within atol 1e-5 (summation
order); bfloat16 compared in float32 within rtol 8e-3, one bf16 ulp, since
each side rounds its f32 mean once. The pad-aware form (``valid_hw``) is
held against JAX ``adaptive_avg_pool2d_valid`` at the four scales. The four
registered operators pass ``torch.library.opcheck`` on the CPU (the band
form is held to the pad-aware form in ``test_torch_spatial_ops.py``). The CUDA
kernel is held against the plain version on the card by the tests marked
``cuda``; JAX is imported inside the tests that use it, so that this file
also runs where only PyTorch is installed (see README).
"""

import numpy as np
import pytest
import torch

from semseg_tpu_torch.ops.kernels import ppm_pool

SCALES = (1, 2, 3, 6)
SHAPES = [(2, 13, 17, 256), (1, 1, 1, 128), (1, 75, 100, 128), (1, 13, 17, 200)]


def _input(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax():
    import jax.numpy as jnp

    from semseg_tpu import ops as jops
    from semseg_tpu.ops.pallas.ppm_pool import pyramid_pool

    return jnp, jops, pyramid_pool


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_f32_matches_pallas_and_adaptive_pool(shape):
    jnp, jops, jax_pyramid_pool = _jax()
    x = _input(shape)
    outs = ppm_pool.pyramid_pool(torch.from_numpy(x))
    pallas = jax_pyramid_pool(jnp.asarray(x), SCALES, interpret=True)
    for s, o, p in zip(SCALES, outs, pallas):
        assert o.shape == (shape[0], s, s, shape[3]) and o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(p), atol=1e-5, rtol=0)
        ref = jops.adaptive_avg_pool2d(jnp.asarray(x), s)
        np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(2, 13, 17, 256), (1, 13, 17, 200)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bf16_matches_pallas(shape):
    jnp, _, jax_pyramid_pool = _jax()
    x = _input(shape, seed=1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    outs = ppm_pool.pyramid_pool(xb)
    pallas = jax_pyramid_pool(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                              SCALES, interpret=True)
    for o, p in zip(outs, pallas):
        assert o.dtype == torch.bfloat16
        np.testing.assert_allclose(o.float().numpy(), np.asarray(p, np.float32),
                                   rtol=8e-3, atol=0)


# Per-sample extents: full, odd, 1x1, and one that covers a single row.
VALID_CASES = [
    ((4, 13, 17, 64), [[13, 17], [7, 9], [1, 1], [1, 17]]),
    ((2, 38, 50, 32), [[38, 50], [25, 33]]),
    ((3, 8, 10, 16), [[8, 10], [5, 10], [8, 3]]),
]


@pytest.mark.parametrize("shape,extents", VALID_CASES,
                         ids=["x".join(map(str, shape)) for shape, _ in VALID_CASES])
def test_valid_form_matches_jax(shape, extents):
    jnp, jops, _ = _jax()
    x = _input(shape, seed=3)
    v = np.array(extents, np.int32)
    outs = ppm_pool.pyramid_pool(torch.from_numpy(x), valid_hw=torch.from_numpy(v))
    for s, o in zip(SCALES, outs):
        assert o.shape == (shape[0], s, s, shape[3]) and o.is_contiguous()
        ref = jops.adaptive_avg_pool2d_valid(jnp.asarray(x), s, jnp.asarray(v))
        np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_valid_form_at_full_extent_is_the_dense_form():
    x = torch.from_numpy(_input((2, 13, 17, 32), seed=4))
    full = torch.tensor([[13, 17], [13, 17]], dtype=torch.int32)
    for o, d in zip(ppm_pool.pyramid_pool(x, valid_hw=full), ppm_pool.pyramid_pool(x)):
        torch.testing.assert_close(o, d, atol=1e-6, rtol=0)


def test_cpu_call_does_not_count_a_launch():
    before = ppm_pool.LAUNCHES, ppm_pool.VALID_LAUNCHES
    x = torch.from_numpy(_input((1, 5, 7, 16)))
    ppm_pool.pyramid_pool(x)
    ppm_pool.pyramid_pool(x, valid_hw=torch.tensor([[3, 4]], dtype=torch.int32))
    assert (ppm_pool.LAUNCHES, ppm_pool.VALID_LAUNCHES) == before


def _opcheck_cases(device="cpu"):
    x = torch.from_numpy(_input((2, 13, 17, 24), seed=9)).to(device)
    v = torch.tensor([[13, 17], [6, 9]], dtype=torch.int32, device=device)
    grads = [torch.from_numpy(_input((2, s, s, 24), seed=10 + s)).to(device) for s in SCALES]
    return {
        "dense": (torch.ops.semseg_tpu_torch.pyramid_pool, (x,)),
        "dense_grad": (torch.ops.semseg_tpu_torch.pyramid_pool, (x.clone().requires_grad_(),)),
        "valid": (torch.ops.semseg_tpu_torch.pyramid_pool_valid, (x, v)),
        "band": (torch.ops.semseg_tpu_torch.pyramid_pool_band,
                 (x[:, 4:9].contiguous(), v, 4, 13)),
        "backward": (torch.ops.semseg_tpu_torch.pyramid_pool_backward, (grads, 13, 17)),
    }


@pytest.mark.parametrize("case", ["dense", "dense_grad", "valid", "band", "backward"])
def test_registered_op_passes_opcheck(case):
    """The registered operators (what ``torch.export`` records and an
    exported program calls) on the CPU: schema, fake implementation
    against the real one, autograd registration, and AOT dispatch with
    dynamic shapes (the dense form's gradient through the backward op)."""
    op, args = _opcheck_cases()[case]
    torch.library.opcheck(op, args)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense", "dense_grad", "valid", "band", "backward"])
def test_registered_op_passes_opcheck_on_card(case):
    """The same checks against the CUDA implementations (the kernels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    op, args = _opcheck_cases("cuda")[case]
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("device,scales,match", [
    ("meta", (1, 2, 3, 6), "unsupported device"),
    ("cpu", (1, 2), "computes scales"),
])
def test_rejects_unsupported_input(device, scales, match):
    x = torch.zeros(1, 4, 4, 8, device=device)
    with pytest.raises(ValueError, match=match):
        ppm_pool.pyramid_pool(x, scales)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 75, 100, 2048), (2, 13, 17, 256), (1, 1, 1, 2048),
                                   (1, 75, 100, 720), (1, 75, 100, 250), (1, 13, 13, 2048)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_on_card(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dtype = getattr(torch, dtype)
    x = torch.from_numpy(_input(shape, seed=2)).to("cuda", dtype)
    before = ppm_pool.LAUNCHES
    outs = ppm_pool.pyramid_pool(x)
    torch.cuda.synchronize()
    assert ppm_pool.LAUNCHES == before + 1
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=0, rtol=8e-3)
    for o, p in zip(outs, ppm_pool.pyramid_pool_plain(x)):
        torch.testing.assert_close(o.float(), p.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,extents", [
    ((8, 75, 100, 2048), [[75, 100], [75, 99], [37, 51], [1, 1], [60, 100], [75, 13],
                          [49, 67], [2, 3]]),
    ((2, 13, 17, 256), [[13, 17], [7, 9]]),
    ((2, 75, 100, 250), [[75, 100], [13, 61]]),
    ((3, 13, 13, 2048), [[0, 0], [1, 13], [13, 1]]),
], ids=["8x75x100x2048", "2x13x17x256", "2x75x100x250", "3x13x13x2048-empty-1row-1col"])
def test_valid_kernel_matches_plain_on_card(shape, extents, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dtype = getattr(torch, dtype)
    x = torch.from_numpy(_input(shape, seed=5)).to("cuda", dtype)
    v = torch.tensor(extents, dtype=torch.int32, device="cuda")
    before = ppm_pool.VALID_LAUNCHES
    outs = ppm_pool.pyramid_pool(x, valid_hw=v)
    torch.cuda.synchronize()
    assert ppm_pool.VALID_LAUNCHES == before + 1
    # bf16: one bf16 ulp, or the f32 summation-order difference where a
    # mean cancels to nearly 0 (its relative error is then unbounded).
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=1e-5, rtol=8e-3)
    for o, p in zip(outs, ppm_pool.pyramid_pool_plain(x, valid_hw=v)):
        torch.testing.assert_close(o.float(), p.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,extents,cuts", [
    ((1, 75, 100, 2048), [[75, 100]], [0, 38, 75]),
    ((1, 75, 100, 2048), [[75, 100]], [0, 19, 38, 57, 75]),
    ((3, 13, 17, 250), [[13, 17], [7, 9], [0, 0]], [0, 1, 2, 7, 8, 13]),
    ((2, 38, 50, 2048), [[38, 50], [21, 33]], [0, 5, 30, 38]),
    # BandPlan(600, 8).rows(8): the flagship's conv5 in 8 bands.
    ((1, 75, 100, 2048), [[75, 100]], [0, 10, 20, 30, 39, 48, 57, 66, 75]),
    # The second sample's extent ends above the last two bands.
    ((2, 75, 100, 2048), [[75, 100], [30, 61]], [0, 19, 38, 57, 75]),
    # 13 x 13: 1-row and 1-column segments, so one-pixel cells, in 1-row bands.
    ((2, 13, 13, 2048), [[13, 13], [11, 12]], list(range(14))),
    ((2, 38, 50, 250), [[38, 50], [17, 49]], [0, 19, 38]),
    # C = 2056: the last channel tile holds 8 channels (bf16) or 4 (f32),
    # so most of its cluster's blocks combine channels past C.
    ((1, 38, 50, 2056), [[38, 50]], [0, 10, 38]),
], ids=["2-bands", "4-bands", "odd-C-1-row-bands-empty-extent", "bins-straddle", "8-bands",
        "band-past-extent", "one-pixel-cells", "C-250", "partial-last-tile"])
def test_band_kernel_matches_plain_on_card(shape, extents, cuts, dtype):
    """Each band's sums against the plain version, two launches bit-equal,
    and the bands' sums turned into grids against the pad-aware form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dtype = getattr(torch, dtype)
    x = torch.from_numpy(_input(shape, seed=11)).to("cuda", dtype)
    v = torch.tensor(extents, dtype=torch.int32, device="cuda")
    h = shape[1]
    before = ppm_pool.BAND_LAUNCHES
    total = 0
    for a, b in zip(cuts, cuts[1:]):
        band = x[:, a:b].contiguous()
        sums = ppm_pool.pyramid_pool_band(band, v, a, h)
        assert torch.equal(sums, ppm_pool.pyramid_pool_band(band, v, a, h))
        torch.testing.assert_close(sums, ppm_pool.pyramid_pool_band_plain(band, v, a, h),
                                   atol=1e-3, rtol=1e-5)
        total = total + sums
    torch.cuda.synchronize()
    assert ppm_pool.BAND_LAUNCHES == before + 2 * (len(cuts) - 1)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=1e-5, rtol=8e-3)
    grids = ppm_pool.band_sums_to_grids(total, v, shape[1:3], dtype)
    for o, p in zip(grids, ppm_pool.pyramid_pool_plain(x, valid_hw=v)):
        torch.testing.assert_close(o.float(), p.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_band_kernel_takes_unaligned_bands(dtype):
    """Bands whose data_ptr is not 16-byte aligned are staged with scalar
    loads: each band against the plain version, bit-equal on repeat."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    shape = (1, 75, 100, 2048)
    flat = torch.from_numpy(_input((int(np.prod(shape)) + 1,), seed=12)).to("cuda",
                                                                            getattr(torch, dtype))
    x = flat[1:].view(shape)
    v = torch.tensor([[75, 100]], dtype=torch.int32, device="cuda")
    for a, b in [(0, 19), (19, 38), (38, 75)]:
        band = x[:, a:b]
        assert band.data_ptr() % 16 != 0
        sums = ppm_pool.pyramid_pool_band(band, v, a, 75)
        assert torch.equal(sums, ppm_pool.pyramid_pool_band(band, v, a, 75))
        torch.testing.assert_close(sums, ppm_pool.pyramid_pool_band_plain(band, v, a, 75),
                                   atol=1e-3, rtol=1e-5)


@pytest.mark.cuda
def test_valid_kernel_rejects_host_extents():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    x = torch.zeros(2, 4, 4, 8, device="cuda")
    with pytest.raises(ValueError, match="valid_hw"):
        ppm_pool.pyramid_pool(x, valid_hw=torch.tensor([[4, 4], [2, 2]], dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_accepts_unaligned_map(dtype):
    """A map whose data_ptr is not 16-byte aligned takes the scalar loads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dtype = getattr(torch, dtype)
    shape = (1, 75, 100, 2048)
    flat = torch.from_numpy(_input((int(np.prod(shape)) + 1,), seed=6)).to("cuda", dtype)
    x = flat[1:].view(shape)
    assert x.data_ptr() % 16 != 0
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=0, rtol=8e-3)
    for o, p in zip(ppm_pool.pyramid_pool(x), ppm_pool.pyramid_pool_plain(x)):
        torch.testing.assert_close(o.float(), p.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("extents", [None, [[75, 100], [37, 51], [0, 0], [1, 100]]],
                         ids=["dense", "valid"])
def test_kernel_repeats_bit_for_bit(extents, dtype):
    """No float atomics: two launches on the same input give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    n = 1 if extents is None else len(extents)
    x = torch.from_numpy(_input((n, 75, 100, 2048), seed=7)).to("cuda", getattr(torch, dtype))
    v = None if extents is None else torch.tensor(extents, dtype=torch.int32, device="cuda")
    for a, b in zip(ppm_pool.pyramid_pool(x, valid_hw=v), ppm_pool.pyramid_pool(x, valid_hw=v)):
        assert torch.equal(a, b)


def _backward_tol(dtype):
    # f32: the kernel and the plain version sum the same terms in the same
    # order; the kernel multiplies by the area's reciprocal, the plain
    # version divides by the area (PyTorch on the card multiplies by its
    # reciprocal too), one rounding apart per term. bf16: one bf16 ulp.
    return dict(atol=1e-6, rtol=1e-6) if dtype == torch.float32 else dict(atol=1e-6, rtol=8e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 80, 128, 2048), (8, 56, 76, 2048), (2, 13, 17, 250),
                                   (1, 4, 5, 2048), (1, 1, 1, 512), (2, 13, 13, 2048)],
                         ids=lambda s: "x".join(map(str, s)))
def test_backward_kernel_matches_plain_on_card(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dtype = getattr(torch, dtype)
    n, h, w, c = shape
    grads = [torch.from_numpy(_input((n, s, s, c), seed=8 + s)).to("cuda", dtype) for s in SCALES]
    x = torch.zeros(shape, device="cuda", dtype=dtype, requires_grad=True)
    before = ppm_pool.BACKWARD_LAUNCHES
    torch.autograd.backward(ppm_pool.pyramid_pool(x), grads)
    torch.cuda.synchronize()
    assert ppm_pool.BACKWARD_LAUNCHES == before + 1
    assert x.grad.is_contiguous() and x.grad.dtype == dtype
    ref = ppm_pool.pyramid_pool_backward_plain(grads, (h, w))
    torch.testing.assert_close(x.grad.float(), ref.float(), **_backward_tol(dtype))
    again = ppm_pool.launch_backward(ppm_pool._lib(), grads, (h, w))
    assert torch.equal(again, x.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_repeats_bit_for_bit_at_the_training_map(dtype):
    """The flagship's batch-2 training conv5: the kernel against the plain
    version, and three launches on the same gradients bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dtype = getattr(torch, dtype)
    grads = [torch.from_numpy(_input((2, s, s, 2048), seed=20 + s)).to("cuda", dtype)
             for s in SCALES]
    outs = [ppm_pool.launch_backward(ppm_pool._lib(), grads, (40, 56)) for _ in range(3)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    ref = ppm_pool.pyramid_pool_backward_plain(grads, (40, 56))
    torch.testing.assert_close(outs[0].float(), ref.float(), **_backward_tol(dtype))


@pytest.mark.cuda
def test_backward_kernel_takes_unaligned_gradients():
    """Gradients whose data_ptr is not 16-byte aligned take scalar loads
    and stores."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    grads = []
    for s in SCALES:
        flat = torch.from_numpy(_input((2 * s * s * 256 + 1,), seed=s)).to("cuda")
        grads.append(flat[1:].view(2, s, s, 256))
    assert grads[0].data_ptr() % 16 != 0
    got = ppm_pool.launch_backward(ppm_pool._lib(), grads, (75, 100))
    ref = ppm_pool.pyramid_pool_backward_plain(grads, (75, 100))
    torch.testing.assert_close(got, ref, **_backward_tol(torch.float32))


@pytest.mark.cuda
def test_valid_form_with_grad_raises_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    x = torch.zeros(2, 8, 8, 64, device="cuda", requires_grad=True)
    v = torch.tensor([[8, 8], [5, 6]], dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="no gradient"):
        ppm_pool.pyramid_pool(x, valid_hw=v)


def _band_cuts(h, bands, base):
    """Row cuts of an ``h``-row map at stride ``base`` split in ``bands``
    bands, as ``cli.train TPU.spatial`` cuts its canvas."""
    from semseg_tpu_torch.parallel.spatial import BandPlan

    return [0] + [b for _, b in BandPlan(base * h, bands, base).rows(base)]


def _band_grads(shape, dtype, seed, unaligned=False):
    n, _, _, c = shape
    grads = []
    for s in SCALES:
        flat = torch.from_numpy(_input((n * s * s * c + 1,), seed=seed + s)).to("cuda", dtype)
        grads.append((flat[1:] if unaligned else flat[:-1]).view(n, s, s, c))
    return grads


def _check_band_rows(grads, hw, cuts, dtype):
    """Each band of ``cuts`` bit-equal to the dense backward kernel's rows,
    repeated bit for bit, and within ``_backward_tol`` of the plain version."""
    lib = ppm_pool._lib()
    dense = ppm_pool.launch_backward(lib, grads, hw)
    for a, b in zip(cuts, cuts[1:]):
        out = ppm_pool.launch_band_backward(lib, grads, a, b - a, hw)
        assert out.shape == (grads[0].shape[0], b - a, hw[1], grads[0].shape[3])
        assert torch.equal(out, dense[:, a:b]), (a, b)
        assert torch.equal(out, ppm_pool.launch_band_backward(lib, grads, a, b - a, hw)), (a, b)
        ref = ppm_pool.pyramid_pool_band_backward_plain(grads, a, b - a, hw)
        torch.testing.assert_close(out.float(), ref.float(), **_backward_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bands", [2, 4])
@pytest.mark.parametrize("shape,base", [((2, 40, 56, 2048), 8), ((2, 14, 19, 2048), 32)],
                         ids=["flagship-2x40x56", "upernet-2x14x19"])
def test_band_backward_kernel_is_the_dense_rows(shape, base, bands, dtype):
    """The split step's own maps (the flagship's batch-2 conv5 at stride 8,
    UPerNet's at stride 32), cut as ``cli.train TPU.spatial`` cuts them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dtype = getattr(torch, dtype)
    grads = _band_grads(shape, dtype, seed=30)
    _check_band_rows(grads, shape[1:3], _band_cuts(shape[1], bands, base), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,unaligned", [((2, 13, 17, 250), False),
                                             ((2, 40, 56, 2048), True), ((1, 4, 5, 256), False)],
                         ids=["odd-C", "unaligned", "4x5"])
def test_band_backward_kernel_one_row_bands_and_scalar_path(shape, unaligned, dtype):
    """Bands of one row each; odd C and gradients one element past a 16-byte
    boundary take the scalar loads and stores; on a 4x5 map a row lies in
    two bins of a scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dtype = getattr(torch, dtype)
    grads = _band_grads(shape, dtype, seed=40, unaligned=unaligned)
    assert (grads[0].data_ptr() % 16 != 0) == unaligned
    _check_band_rows(grads, shape[1:3], list(range(shape[1] + 1)), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_band_backward_op_counts_its_launch(dtype):
    """The registered operator launches the kernel once a call, and agrees
    with a direct launch bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dtype = getattr(torch, dtype)
    grads = _band_grads((2, 40, 56, 2048), dtype, seed=50)
    before = ppm_pool.BAND_BACKWARD_LAUNCHES
    out = torch.ops.semseg_tpu_torch.pyramid_pool_band_backward(grads, 10, 10, 40, 56)
    torch.cuda.synchronize()
    assert ppm_pool.BAND_BACKWARD_LAUNCHES == before + 1
    assert torch.equal(out, ppm_pool.launch_band_backward(ppm_pool._lib(), grads, 10, 10,
                                                          (40, 56)))
