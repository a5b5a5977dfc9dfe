"""``TPU.remat`` in the port: activation checkpointing of the ResNet blocks.

The set-up of ``test_torch_train_step.py`` (JAX's seeded variables crossing
into the port, float64 compute, two ``train_step``s on seeded batches) with
resnet18dilated + c1_deepsup (no dropout, so JAX runs unpatched):

* remat against the port without it: loss, accuracy, every gradient,
  parameter and BN buffer (``_running_iter`` too) equal bit for bit. The
  recompute in the backward runs each block's forward a second time; a
  training BN inside it must not advance the running statistics again;
* against JAX's ``train_step`` with ``TPU.remat`` (``nn.remat`` on each
  ``ResBlock``), at ``test_torch_train_step.py``'s limits;
* without the recompute guard the buffers do advance twice (the fault the
  guard closes), and eval and the non-ResNet encoders take no checkpoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semseg_tpu.models import ModelBuilder as JaxModelBuilder
from semseg_tpu.parallel import create_train_state as jax_create_train_state

from semseg_tpu_torch.models import ModelBuilder
from semseg_tpu_torch.models import layers
from semseg_tpu_torch.models.convert import state_dicts_from_jax
from semseg_tpu_torch.models.resnet import ResBlock
from semseg_tpu_torch.parallel import create_train_state
from test_torch_train_step import (
    check_metrics,
    check_params,
    jax_variables,
    make_batch,
    run_jax,
    run_port,
    small_cfgs,
)

DECODER = "c1_deepsup"


@pytest.fixture(autouse=True)
def x64():
    with jax.enable_x64(True):
        yield


@pytest.fixture(scope="module")
def variables():
    with jax.enable_x64(True):
        return jax.tree.map(np.asarray, dict(jax_variables(DECODER)))


def build(variables, remat):
    """The port's train state from the JAX variables, ``TPU.remat`` set."""
    _, tc = small_cfgs(DECODER)
    tc.TPU.remat = remat
    model = ModelBuilder.build_model(tc, device="cpu")
    enc, dec = state_dicts_from_jax(variables, tc.MODEL.arch_encoder, DECODER)
    model.encoder.load_state_dict(enc, strict=True)
    model.decoder.load_state_dict(dec, strict=True)
    return create_train_state(tc, model.train())


BATCHES = [make_batch(21), make_batch(22)]


@pytest.fixture(scope="module")
def runs(variables):
    """remat → (the port's state after two steps on BATCHES, its metrics)."""
    out = {}
    for remat in (False, True):
        state = build(variables, remat)
        out[remat] = (state, run_port(state, BATCHES))
    return out


def test_remat_equals_plain_bit_for_bit(runs):
    (plain, plain_metrics), (remat, remat_metrics) = runs[False], runs[True]
    blocks = [m for m in remat.model.modules() if isinstance(m, ResBlock)]
    assert blocks and all(b.remat for b in blocks)
    assert not any(m.remat for m in plain.model.modules() if isinstance(m, ResBlock))
    assert remat_metrics == plain_metrics
    for (k, a), b in zip(plain.model.named_parameters(), remat.model.parameters()):
        assert torch.equal(a, b), k
        assert torch.equal(a.grad, b.grad), k
    buffers = dict(remat.model.named_buffers())
    for k, a in plain.model.named_buffers():
        assert torch.equal(a, buffers[k]), k
    it = remat.model.encoder.layer4[1].bn2._running_iter
    np.testing.assert_allclose(float(it), (1 * 0.999 + 1) * 0.999 + 1, rtol=1e-7)


def test_remat_two_steps_match_jax_remat(variables, runs):
    jc, _ = small_cfgs(DECODER)
    jc.TPU.remat = True
    jstate = jax_create_train_state(jc, JaxModelBuilder.build_model(jc, dtype=jnp.float64),
                                    variables)
    jstate = jstate.replace(batch_stats=jax.tree.map(lambda a: a.astype(jnp.float64),
                                                     jstate.batch_stats))
    jstate, ref = run_jax(jstate, BATCHES)
    state, metrics = runs[True]
    check_metrics(metrics, ref)
    check_params(jstate, state, DECODER)


def test_without_the_guard_the_recompute_advances_bn_twice(variables, monkeypatch):
    """The fault the recompute guard closes: a checkpointed block's BN runs
    its training forward again in the backward and, unguarded, advances its
    running statistics a second time; BN outside the blocks (the stem)
    advances once."""
    remat = build(variables, True)
    monkeypatch.setattr(layers, "in_recompute", lambda: False)
    run_port(remat, BATCHES[:1])
    assert float(remat.model.encoder.bn1._running_iter) == pytest.approx(1.999)
    block = remat.model.encoder.layer1[0].bn1
    assert float(block._running_iter) == pytest.approx(1.999 * 0.999 + 1)


def test_remat_only_in_resnet_training(monkeypatch):
    """Eval and no-grad forwards take no checkpoint; MobileNetV2 and HRNetV2
    have no remat (JAX passes it to the ResNet family only)."""
    import torch.utils.checkpoint as ckpt

    from semseg_tpu_torch.models import resnet

    calls = []
    real = ckpt.checkpoint
    monkeypatch.setattr(resnet, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    enc = ModelBuilder.build_encoder("resnet18dilated", device="cpu", remat=True)
    plain = ModelBuilder.build_encoder("resnet18dilated", device="cpu")
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    for a, b in zip(enc(x), plain(x)):
        assert torch.equal(a, b)
    assert not calls
    enc.train()
    with torch.no_grad():
        enc(x)
    assert not calls
    sum(f.sum() for f in enc(x)).backward()
    assert len(calls) == 8  # 2 blocks x 4 stages
    for arch in ("mobilenetv2dilated", "hrnetv2"):
        enc = ModelBuilder.build_encoder(arch, device="cpu", remat=True)
        assert not [m for m in enc.modules() if getattr(m, "remat", False)]
