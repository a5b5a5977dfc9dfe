"""The port's training ops against the JAX package's, on the CPU.

* Losses (``ops.losses``): masked softmax cross-entropy and NLL from f32 and
  bf16 logits, with some void pixels and with all void (loss 0, not NaN),
  and ``pixel_accuracy``; f32 within 1e-6 relative (logsumexp summation
  order).
* ``batch_norm_train``: outputs and the new running mean, variance and
  ``iter`` against JAX, with a channel whose variance is below eps (the
  clamp), the ``n == 1`` error, and the input, scale and bias gradients
  against ``jax.vjp``; f32 within 1e-5 (one-pass sums in another order).
* The dense ``pyramid_pool``'s input gradient (its plain backward, which
  the CPU runs) against ``jax.vjp`` of ``semseg_tpu.ops.pool.
  adaptive_avg_pool2d`` summed over the four scales, at 75x100, 8x8, 6x6,
  4x5 and 1x1 (below 6 a pixel lies in several bins of one scale per axis);
  f32 within 1e-6 of the largest gradient (the 1x1 map sums 50 terms per
  pixel, in another order than JAX); ``gradcheck`` in f64. A grad-enabled
  pad-aware call raises.
* ``Dropout2d`` with the trainer's generator; the optimizer (``decay_mask``,
  ``poly_schedule``, ``current_lrs``, two SGD updates against optax on the
  same tree within 1e-7); the converter's ``iter``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semseg_tpu import ops as jops
from semseg_tpu.ops import norm as jnorm

from semseg_tpu_torch.models.convert import (
    load_reference_pth,
    reference_state_dict,
    state_dicts_from_jax,
)
from semseg_tpu_torch.models.layers import BatchNorm2d, Dropout2d
from semseg_tpu_torch.ops import losses
from semseg_tpu_torch.ops.kernels import ppm_pool
from semseg_tpu_torch.ops.norm import batch_norm_train

SCALES = (1, 2, 3, 6)


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


def _logits_labels(seed, void):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(2, 12, 16, 150) * 3).astype(np.float32)
    labels = rng.randint(0, 150, (2, 12, 16)).astype(np.int32)
    labels[rng.rand(*labels.shape) < void] = -1
    return logits, labels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("void", [0.0, 0.3, 1.0], ids=["no-void", "some-void", "all-void"])
def test_losses_match_jax(dtype, void):
    logits, labels = _logits_labels(0, void)
    jl = jnp.asarray(logits, dtype)
    tl = _nchw(np.asarray(jl.astype(jnp.float32))).to(getattr(torch, dtype))
    tlab = torch.from_numpy(labels)
    ce = float(losses.softmax_cross_entropy_with_ignore(tl, tlab))
    ref = float(jops.softmax_cross_entropy_with_ignore(jl, jnp.asarray(labels)))
    np.testing.assert_allclose(ce, ref, rtol=1e-6)
    logp = jax.nn.log_softmax(jl.astype(jnp.float32), axis=-1)
    nll = float(losses.nll_loss(_nchw(np.asarray(logp)), tlab))
    np.testing.assert_allclose(nll, float(jops.nll_loss(logp, jnp.asarray(labels))), rtol=1e-6)
    acc = float(losses.pixel_accuracy(tl, tlab))
    np.testing.assert_allclose(acc, float(jops.pixel_accuracy(jl, jnp.asarray(labels))),
                               rtol=1e-6)
    if void == 1.0:
        assert ce == 0.0 and nll == 0.0 and acc == 0.0
        # The bare library call gives NaN here, hence the masked mean.
        assert np.isnan(float(torch.nn.functional.cross_entropy(
            tl.float(), tlab.long(), ignore_index=-1)))


def test_loss_gradient_is_finite_when_all_void():
    logits, labels = _logits_labels(1, 1.0)
    tl = _nchw(logits).requires_grad_()
    losses.softmax_cross_entropy_with_ignore(tl, torch.from_numpy(labels)).backward()
    assert torch.equal(tl.grad, torch.zeros_like(tl))


def _bn_inputs(seed, shape=(2, 6, 7, 16)):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    x[..., 3] = 0.25 + 1e-4 * rng.randn(*shape[:3])  # variance ~1e-8 < eps: clamped
    scale = (rng.rand(shape[-1]) + 0.5).astype(np.float32)
    bias = rng.randn(shape[-1]).astype(np.float32)
    mean = (rng.randn(shape[-1]) * 0.1).astype(np.float32)
    var = (rng.rand(shape[-1]) + 0.5).astype(np.float32)
    return x, scale, bias, mean, var, np.float32(2.5)


def test_batch_norm_train_matches_jax():
    x, scale, bias, mean, var, it = _bn_inputs(0)
    y, m, v, i = jnorm.batch_norm_train(jnp.asarray(x), scale, bias, mean, var, it)
    ty, tm, tv, ti = batch_norm_train(
        _nchw(x), *(torch.from_numpy(a) for a in (scale, bias, mean, var)),
        torch.tensor([it]))
    np.testing.assert_allclose(ty.permute(0, 2, 3, 1).numpy(), np.asarray(y), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tm.numpy(), np.asarray(m), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(v), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(ti.numpy(), [float(i)], rtol=1e-7)
    # The clamped channel: rsqrt(max(var, eps)) = 316, so (x - mean) ~ 1e-4
    # moves it ~0.03 * scale off its bias; sqrt(var + eps) would agree too.
    assert np.abs(ty[:, 3].numpy() - bias[3]).max() < 0.2 * scale[3]


def test_batch_norm_train_gradient_matches_jax():
    x, scale, bias, mean, var, it = _bn_inputs(1)
    cot = np.random.RandomState(2).randn(*x.shape).astype(np.float32)

    def f(xx, ss, bb):
        return jnorm.batch_norm_train(xx, ss, bb, mean, var, it)[0]

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    gx, gs, gb = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    tx = _nchw(x).requires_grad_()
    ts, tb = torch.from_numpy(scale).requires_grad_(), torch.from_numpy(bias).requires_grad_()
    y = batch_norm_train(tx, ts, tb, torch.from_numpy(mean), torch.from_numpy(var),
                         torch.tensor([it]))[0]
    y.backward(_nchw(cot))
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), gx,
                               atol=1e-4 * np.abs(gx).max(), rtol=0)
    np.testing.assert_allclose(ts.grad.numpy(), gs, atol=1e-5 * np.abs(gs).max(), rtol=0)
    np.testing.assert_allclose(tb.grad.numpy(), gb, atol=1e-5 * np.abs(gb).max(), rtol=0)


def test_batch_norm_train_rejects_one_element():
    x = torch.zeros(1, 4, 1, 1)
    with pytest.raises(ValueError, match=">1 element"):
        batch_norm_train(x, *(torch.ones(4) for _ in range(4)), torch.ones(1))
    with pytest.raises(ValueError, match=">1 element"):
        jnorm.batch_norm_train(jnp.zeros((1, 1, 1, 4)), *(jnp.ones(4) for _ in range(4)),
                               jnp.float32(1))


def test_batch_norm_module_trains_then_infers():
    bn = BatchNorm2d(16).train()
    x, *_ = _bn_inputs(3)
    bn(_nchw(x))
    assert float(bn._running_iter) == pytest.approx(1.999)
    assert not torch.equal(bn.running_mean, torch.zeros(16))
    bn.eval()
    y = bn(_nchw(x))
    assert float(bn._running_iter) == pytest.approx(1.999) and y.shape == (2, 16, 6, 7)


# (40, 56), (56, 76), (80, 128): conv5 of the flagship's batch-2 training
# canvases (short sides 300-600 on the 64-lattice, TRAIN.batch_size_per_gpu 2).
@pytest.mark.parametrize("hw", [(75, 100), (8, 8), (6, 6), (4, 5), (1, 1), (40, 56), (56, 76),
                                (80, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_pool_gradient_matches_jax_vjp(hw):
    rng = np.random.RandomState(hw[0] * 101 + hw[1])
    x = rng.randn(2, *hw, 24).astype(np.float32)
    cots = [rng.randn(2, s, s, 24).astype(np.float32) for s in SCALES]

    def f(xx):
        return [jops.adaptive_avg_pool2d(xx, s) for s in SCALES]

    _, vjp = jax.vjp(f, jnp.asarray(x))
    (ref,) = vjp([jnp.asarray(c) for c in cots])
    tx = torch.from_numpy(x).requires_grad_()
    outs = ppm_pool.pyramid_pool(tx)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cots])
    assert tx.grad.shape == x.shape and tx.grad.is_contiguous()
    ref = np.asarray(ref)
    np.testing.assert_allclose(tx.grad.numpy(), ref, atol=1e-6 * np.abs(ref).max(), rtol=0)
    # The plain backward, called directly, is what the card's kernel is held to.
    direct = ppm_pool.pyramid_pool_backward_plain([torch.from_numpy(c) for c in cots], hw)
    torch.testing.assert_close(direct, tx.grad, atol=0, rtol=0)


@pytest.mark.parametrize("hw", [(7, 9), (3, 2)], ids=lambda s: "x".join(map(str, s)))
def test_pool_gradcheck_f64(hw):
    x = torch.randn(1, *hw, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0)).requires_grad_()
    assert torch.autograd.gradcheck(lambda t: ppm_pool.pyramid_pool(t), (x,))


def test_pool_gradient_in_bf16_rounds_once():
    rng = np.random.RandomState(5)
    cots = [torch.from_numpy(rng.randn(1, s, s, 16).astype(np.float32)).to(torch.bfloat16)
            for s in SCALES]
    got = ppm_pool.pyramid_pool_backward_plain(cots, (13, 17))
    f32 = ppm_pool.pyramid_pool_backward_plain([c.float() for c in cots], (13, 17))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, f32.to(torch.bfloat16))


def test_valid_form_with_grad_raises_and_cpu_counts_nothing():
    x = torch.randn(2, 8, 8, 16, requires_grad=True)
    v = torch.tensor([[8, 8], [5, 6]], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no gradient"):
        ppm_pool.pyramid_pool(x, valid_hw=v)
    with torch.no_grad():
        ppm_pool.pyramid_pool(x, valid_hw=v)
    before = ppm_pool.LAUNCHES, ppm_pool.BACKWARD_LAUNCHES
    sum(o.sum() for o in ppm_pool.pyramid_pool(x)).backward()
    assert (ppm_pool.LAUNCHES, ppm_pool.BACKWARD_LAUNCHES) == before


def test_dropout2d_drops_whole_channels_from_the_generator():
    x = torch.ones(8, 512, 4, 4).to(memory_format=torch.channels_last)
    drop = Dropout2d(0.1).train()
    drop.generator = torch.Generator().manual_seed(7)
    y = drop(x)
    per_channel = y.flatten(2)
    assert torch.all(per_channel.amax(2) == per_channel.amin(2))  # whole maps
    kept = per_channel[:, :, 0]
    assert torch.all((kept == 0) | torch.isclose(kept, torch.tensor(1 / 0.9)))
    assert 0.08 < float((kept == 0).float().mean()) < 0.12
    assert y.is_contiguous(memory_format=torch.channels_last)
    drop.generator = torch.Generator().manual_seed(7)
    assert torch.equal(drop(x), y)
    assert torch.equal(drop.eval()(x), x)


def _narrow_jax_variables():
    """Seeded variables of a narrow JAX model (``model.init`` under ``jit``,
    ~4x faster than the eager ``init_variables`` on the CPU)."""
    from semseg_tpu.models import decoders as jdec, resnet as jres
    from semseg_tpu.models.segmentation import SegmentationModel

    model = SegmentationModel(
        encoder=jres.ResNetEncoder(block="bottleneck", dilate_scale=8, layers=(1, 1, 1, 1),
                                   planes=(8, 16, 32, 64)),
        decoder=jdec.PPMDeepsup(num_class=150, fc_dim=256), deep_sup_scale=0.4)
    keys = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    img, label = jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 8, 8), jnp.int32)
    variables = jax.jit(lambda: model.init(keys, img, seg_label=label, train=True))()
    return jax.tree.map(np.asarray, dict(variables))


def _narrow_port_model(variables):
    from semseg_tpu_torch.models import SegmentationModel
    from semseg_tpu_torch.models.decoders import PPMDeepsup
    from semseg_tpu_torch.models.resnet import ResNetEncoder

    model = SegmentationModel(
        ResNetEncoder(dilate_scale=8, layers=(1, 1, 1, 1), planes=(8, 16, 32, 64)),
        PPMDeepsup(num_class=150, fc_dim=256), deep_sup_scale=0.4)
    enc, dec = state_dicts_from_jax(variables, "resnet50dilated", "ppm_deepsup")
    model.encoder.load_state_dict(enc, strict=True)
    model.decoder.load_state_dict(dec, strict=True)
    return model


def _to_port_keys(tree):
    """A params-shaped tree → {port key: tensor}, via the converter."""
    enc, dec = state_dicts_from_jax({"params": tree}, "resnet50dilated", "ppm_deepsup")
    return {**{f"encoder.{k}": v for k, v in enc.items()},
            **{f"decoder.{k}": v for k, v in dec.items()}}


@pytest.fixture(scope="module")
def narrow():
    return _narrow_jax_variables()


def test_decay_mask_matches_jax(narrow):
    from semseg_tpu.parallel.train_step import decay_mask as jax_decay_mask
    from semseg_tpu_torch.parallel import decay_mask

    params = narrow["params"]
    jmask = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                         jax_decay_mask(params), params)
    ref = {k: bool(v.flatten()[0]) for k, v in _to_port_keys(jmask).items()}
    model = _narrow_port_model(narrow)
    mine = {f"{part}.{k}": v for part in ("encoder", "decoder")
            for k, v in decay_mask(getattr(model, part)).items()}
    assert mine == ref
    assert mine["decoder.conv_last.4.weight"] and not mine["decoder.conv_last.4.bias"]
    assert not mine["encoder.bn1.weight"]


def test_poly_schedule_and_current_lrs_match_jax():
    from semseg_tpu.config import cfg as jcfg
    from semseg_tpu.parallel.train_step import current_lrs as jlrs, poly_schedule as jpoly
    from semseg_tpu_torch.config import cfg
    from semseg_tpu_torch.parallel import current_lrs, poly_schedule

    for step in (0, 1, 999, 50_000, 100_000, 120_000):
        np.testing.assert_allclose(poly_schedule(0.02, 100_000, 0.9)(step),
                                   float(jpoly(0.02, 100_000, 0.9)(step)), rtol=1e-6)
        np.testing.assert_allclose(current_lrs(cfg, step), jlrs(jcfg, step), rtol=1e-12)


def test_sgd_updates_match_optax(narrow):
    """Two updates of the two-group SGD (decay on conv weights only,
    momentum) against the JAX package's optax chain on the same tree."""
    import optax

    from semseg_tpu.config import cfg as jcfg
    from semseg_tpu.parallel.train_step import make_optimizer as jax_make_optimizer
    from semseg_tpu_torch.config import cfg
    from semseg_tpu_torch.parallel import create_train_state

    for c in (jcfg, cfg):
        assert c.TRAIN.lr_encoder == c.TRAIN.lr_decoder
    c = cfg.clone()
    c.TRAIN.lr_decoder = 0.01  # the two groups' rates differ
    jc = jcfg.clone()
    jc.TRAIN.lr_decoder = 0.01
    params = narrow["params"]
    tx = jax_make_optimizer(jc, params)
    opt_state = tx.init(params)
    model = _narrow_port_model(narrow)
    state = create_train_state(c, model)
    rng = np.random.RandomState(3)
    for step in range(2):
        grads = jax.tree.map(lambda p: rng.randn(*np.shape(p)).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        tgrads = _to_port_keys(grads)
        for name, p in model.named_parameters():
            p.grad = tgrads[name].clone()
        for g in state.optimizer.param_groups:
            g["lr"] = g["base_lr"] * (1 - step / state.max_iters) ** state.lr_pow
        state.optimizer.step()
    ref = _to_port_keys(jax.tree.map(np.asarray, params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), atol=1e-7, rtol=1e-6,
                                   err_msg=name)


def test_converter_carries_iter(narrow, tmp_path):
    """``iter`` crosses into ``_running_iter``; the reference format written
    by ``reference_state_dict`` reads back strict, and a file without
    ``_running_iter`` loads with 1."""
    stats = jax.tree.map(lambda a: a * 0 + 3.5 if a.ndim == 0 else a, narrow["batch_stats"])
    variables = {"params": narrow["params"], "batch_stats": stats}
    enc, _ = state_dicts_from_jax(variables, "resnet50dilated", "ppm_deepsup")
    assert torch.equal(enc["bn1._running_iter"], torch.tensor([3.5]))
    model = _narrow_port_model(variables)
    assert float(model.encoder.layer4[0].bn3._running_iter) == 3.5
    ref = reference_state_dict(model.encoder.state_dict())
    torch.testing.assert_close(ref["bn1._tmp_running_var"], enc["bn1.running_var"] * 3.5)
    torch.save(ref, tmp_path / "enc.pth")
    model.encoder.load_state_dict(load_reference_pth(str(tmp_path / "enc.pth")), strict=True)
    old = {k: v for k, v in enc.items() if not k.endswith("_running_iter")}
    model.encoder.load_state_dict(old, strict=True)
    assert float(model.encoder.bn1._running_iter) == 1.0
