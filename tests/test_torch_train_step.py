"""The port's train step against the JAX package's, on the CPU.

The small config of ``tests/test_train_step.py`` (resnet18dilated +
ppm_deepsup, fc_dim 512), batch 2, 64x64: the JAX model is initialised with
its seeded random weights, which cross into the port through
``state_dicts_from_jax``; the same seeded numpy batches go through two
steps of both ``train_step``s. Dropout draws differ between the frameworks,
so its rate is 0 on both sides (the JAX decoders' ``Dropout2d`` is patched
inside the test; c1_deepsup has no dropout and runs unpatched).
Compared: loss and accuracy at each step, every parameter and every BN
running mean, variance and ``iter`` after step 2.

Both sides compute in float64 (``TPU.compute_dtype``, JAX under
``enable_x64``), with float32 parameters and statistics: then the loss
agrees to ~1e-10 relative and every parameter to one float32 ulp
(measured: 1.2e-7), which holds the algorithm to the JAX package's exactly.
In float32 the frameworks' convolutions and batch-norm sums round in other
orders, and two steps are chaotic: the PPM's scale-1 branch normalises over
N x 1 x 1 = 2 values, so measured on this CPU the first-step losses agree
to 6.4e-6 relative but after one update parameters differ by up to 0.065
and the second-step loss by 3e-3 relative (the JAX package's own test of
the uint8 path, ``tests/test_train_step.py:135-148``, says the same).
Limits here: loss rtol 1e-8, parameters and statistics atol 1e-6.

This file holds ppm_deepsup, ``TRAIN.fix_bn`` and the uint8 batch;
``test_torch_train_step_accum.py`` holds ``grad_accum=2`` and c1_deepsup.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from semseg_tpu.config import cfg as jax_cfg
from semseg_tpu.models import ModelBuilder as JaxModelBuilder, decoders as jax_decoders
from semseg_tpu.parallel import create_train_state as jax_create_train_state
from semseg_tpu.parallel import train_step as jax_train_step

from semseg_tpu_torch.config import cfg
from semseg_tpu_torch.models import ModelBuilder
from semseg_tpu_torch.models.convert import state_dicts_from_jax
from semseg_tpu_torch.models.layers import Dropout2d
from semseg_tpu_torch.parallel import create_train_state, train_step

LOSS_RTOL = 1e-8
PARAM_TOL = dict(atol=1e-6, rtol=0)
FROZEN_BN_RTOL = 1e-6


class _NoDropout(fnn.Module):
    """The JAX ``Dropout2d`` at rate 0, whatever rate it is built with."""

    rate: float

    @fnn.compact
    def __call__(self, x, *, train: bool = False):
        return x


def small_cfgs(decoder="ppm_deepsup", fix_bn=False):
    out = []
    for base in (jax_cfg, cfg):
        c = base.clone()
        c.MODEL.arch_encoder = "resnet18dilated"
        c.MODEL.arch_decoder = decoder
        c.MODEL.fc_dim = 512
        c.TRAIN.num_epoch = 2
        c.TRAIN.epoch_iters = 10
        c.TRAIN.fix_bn = fix_bn
        c.TPU.compute_dtype = "float64"
        out.append(c)
    return out


def make_batch(seed, n=2, hw=(64, 64), ds=8):
    rng = np.random.RandomState(seed)
    return {
        "img_data": rng.randn(n, hw[0], hw[1], 3).astype(np.float32),
        "seg_label": rng.randint(-1, 150, (n, hw[0] // ds, hw[1] // ds)).astype(np.int32),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


@pytest.fixture(autouse=True)
def x64():
    with jax.enable_x64(True):
        yield


def jax_variables(decoder="ppm_deepsup"):
    """Seeded variables of the small JAX model: ``init_variables``'s
    ``model.init`` under ``jit``, ~4x faster than eager on the CPU."""
    model = JaxModelBuilder.build_model(small_cfgs(decoder)[0], dtype=jnp.float64)
    img = jnp.zeros((1, 64, 64, 3), jnp.float32)
    label = jnp.zeros((1, 8, 8), jnp.int32)
    keys = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    return jax.jit(lambda: model.init(keys, img, seg_label=label, train=True))()


def build_pair(variables, decoder="ppm_deepsup", fix_bn=False):
    """(JAX state, port state) from the same JAX variables."""
    jc, tc = small_cfgs(decoder, fix_bn)
    jmodel = JaxModelBuilder.build_model(jc, dtype=jnp.float64)
    # The statistics turn float64 at the first float64 step in JAX; start
    # them there, so that grad_accum's scan carries one dtype.
    jstate = jax_create_train_state(jc, jmodel, variables)
    jstate = jstate.replace(batch_stats=jax.tree.map(lambda a: a.astype(jnp.float64),
                                                     jstate.batch_stats))
    model = ModelBuilder.build_model(tc, device="cpu")
    enc, dec = state_dicts_from_jax(jax.tree.map(np.asarray, dict(variables)),
                                    tc.MODEL.arch_encoder, decoder)
    model.encoder.load_state_dict(enc, strict=True)
    model.decoder.load_state_dict(dec, strict=True)
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.0
    model.train()
    return jstate, create_train_state(tc, model)


def run_jax(jstate, batches, grad_accum=1):
    step = jax.jit(functools.partial(jax_train_step, grad_accum=grad_accum))
    metrics = []
    for b in batches:
        jstate, m = step(jstate, b, jax.random.PRNGKey(0))
        metrics.append((float(m["loss"]), float(m["acc"])))
    return jstate, metrics


def run_port(state, batches, grad_accum=1):
    metrics = []
    for b in batches:
        m = train_step(state, _torch_batch(b), None, grad_accum)
        metrics.append((float(m["loss"]), float(m["acc"])))
    return metrics


def check_params(jstate, state, arch_decoder):
    """Every port parameter and statistic equals JAX's after conversion."""
    enc, dec = state_dicts_from_jax(
        jax.tree.map(np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}),
        "resnet18dilated", arch_decoder)
    for ref, module in ((enc, state.model.encoder), (dec, state.model.decoder)):
        mine = module.state_dict()
        assert sorted(ref) == sorted(mine)
        for k, r in ref.items():
            if k.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(mine[k].numpy(), r.numpy(), err_msg=k, **PARAM_TOL)


def check_metrics(port, ref, loss_rtol=LOSS_RTOL):
    for (pl, pa), (jl, ja) in zip(port, ref):
        np.testing.assert_allclose(pl, jl, rtol=loss_rtol)
        np.testing.assert_allclose(pa, ja, atol=1e-9)


@pytest.fixture(scope="module")
def ppm_variables():
    with jax.enable_x64(True):
        return jax_variables()


def test_ppm_deepsup_two_steps_match_jax(ppm_variables, monkeypatch):
    monkeypatch.setattr(jax_decoders, "Dropout2d", _NoDropout)
    jstate, state = build_pair(ppm_variables)
    batches = [make_batch(1), make_batch(2)]
    jstate, ref = run_jax(jstate, batches)
    check_metrics(run_port(state, batches), ref)
    assert state.step == 2 and int(jstate.step) == 2
    check_params(jstate, state, "ppm_deepsup")
    # Statistics moved and iter advanced twice: 1 -> 1.999 -> 2.997001.
    it = state.model.encoder.bn1._running_iter
    np.testing.assert_allclose(float(it), (1 * 0.999 + 1) * 0.999 + 1, rtol=1e-7)


def test_fix_bn_two_steps_match_jax(ppm_variables, monkeypatch):
    """TRAIN.fix_bn: statistics frozen, the deep-supervision branch trains."""
    monkeypatch.setattr(jax_decoders, "Dropout2d", _NoDropout)
    jstate, state = build_pair(ppm_variables, fix_bn=True)
    before = {k: v.clone() for k, v in state.model.state_dict().items() if "running" in k}
    batches = [make_batch(5), make_batch(6)]
    jstate, ref = run_jax(jstate, batches)
    # Frozen BN folds its float32 running statistics into a float32 affine
    # on both sides (rsqrt may round an ulp apart): measured 2.8e-7.
    check_metrics(run_port(state, batches), ref, loss_rtol=FROZEN_BN_RTOL)
    check_params(jstate, state, "ppm_deepsup")
    after = state.model.state_dict()
    assert all(torch.equal(v, after[k]) for k, v in before.items())
    assert state.model.decoder.training and not state.model.decoder.cbr_deepsup[1].training
    assert state.model.decoder.conv_last_deepsup.weight.grad is not None


def test_uint8_batch_matches_float_batch():
    """A uint8 batch with per-image valid extents, normalised on the device,
    against the host-normalised float32 batch with zero padding
    (tests/test_train_step.py:100): the normalise itself within 1e-6;
    the step within the JAX test's limits (loss rtol 1e-4, parameters atol
    5e-3), since a few-ulp input difference grows through the backward."""
    from semseg_tpu_torch.data.transforms import MEAN, STD
    from semseg_tpu_torch.parallel import dropout_generator
    from semseg_tpu_torch.parallel.train_step import _images

    rng = np.random.RandomState(9)
    hw = np.array([[56, 64], [64, 48]], np.int32)
    raw = np.zeros((2, 64, 64, 3), np.uint8)
    host = np.zeros((2, 64, 64, 3), np.float32)
    for i, (h, w) in enumerate(hw):
        px = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        raw[i, :h, :w] = px
        host[i, :h, :w] = (px.astype(np.float32) / 255.0 - MEAN) / STD
    label = rng.randint(-1, 150, (2, 8, 8)).astype(np.int32)
    rb = _torch_batch({"img_data": raw, "seg_label": label, "img_valid_hw": hw})
    np.testing.assert_allclose(_images(rb).permute(0, 2, 3, 1).numpy(), host, atol=1e-6, rtol=0)

    tc = small_cfgs()[1]
    tc.TPU.compute_dtype = "float32"
    states = [create_train_state(tc, ModelBuilder.build_model(tc, device="cpu").train())
              for _ in range(2)]
    m_host = train_step(states[0], _torch_batch({"img_data": host, "seg_label": label}),
                        dropout_generator(0, 0))
    m_raw = train_step(states[1], rb, dropout_generator(0, 0))
    np.testing.assert_allclose(float(m_host["loss"]), float(m_raw["loss"]), rtol=1e-4)
    # channels_last survives the backward and the optimizer's in-place update.
    for k, p in states[1].model.named_parameters():
        if p.dim() == 4:
            assert p.is_contiguous(memory_format=torch.channels_last), k
            assert p.grad.is_contiguous(memory_format=torch.channels_last), k
    for (k, a), b in zip(states[0].model.named_parameters(), states[1].model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=5e-3, rtol=0,
                                   err_msg=k)
