"""The port's pyramid pool against the JAX package's Pallas kernel.

On the CPU the port's ``pyramid_pool`` runs its plain version; it is held
against JAX ``pyramid_pool(..., interpret=True)`` and against four
``ops.adaptive_avg_pool2d`` calls. float32 within atol 1e-5 (summation
order); bfloat16 compared in float32 within rtol 8e-3, one bf16 ulp, since
each side rounds its f32 mean once. The pad-aware form (``valid_hw``) is
held against JAX ``adaptive_avg_pool2d_valid`` at the four scales. The three
registered operators pass ``torch.library.opcheck`` on the CPU. The CUDA
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
        "backward": (torch.ops.semseg_tpu_torch.pyramid_pool_backward, (grads, 13, 17)),
    }


@pytest.mark.parametrize("case", ["dense", "dense_grad", "valid", "backward"])
def test_registered_op_passes_opcheck(case):
    """The registered operators (what ``torch.export`` records and an
    exported program calls) on the CPU: schema, fake implementation
    against the real one, autograd registration, and AOT dispatch with
    dynamic shapes (the dense form's gradient through the backward op)."""
    op, args = _opcheck_cases()[case]
    torch.library.opcheck(op, args)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense", "dense_grad", "valid", "backward"])
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
