"""``TPU.remat`` under ``TPU.spatial``: the split train step with each banded
ResNet block checkpointed over all its bands (``models.resnet.banded_block``),
on the CPU in float64.

* resnet18dilated + ppm_deepsup (``test_torch_spatial_train_step.py``'s
  small config, dropout on from the step's generator) split in 2 and 4 CPU
  bands, and resnet18 + upernet (``PAIRS["resnet18_upernet"]`` of
  ``test_torch_spatial_zoo_train.py``: output stride 32, 128x64) in 2: two
  steps with remat against the same split steps without it, from the same
  weights and batches. Loss, accuracy, every parameter, gradient and
  buffer bit-equal; ``_running_iter`` advanced twice; each ``ResBlock``
  recomputed once a step (``resnet.RECOMPUTES``).
* HRNetV2 and MobileNetV2 built with ``TPU.remat`` take no checkpoint in
  their banded forwards, as JAX gives remat to the ResNets only.
* Each block's recompute runs in the backward of the node that joins its
  bands' output gradients (over bands on several cards autograd runs each
  card's part of the backward on a thread of its own).

The JAX anchor of the split remat step is
``test_torch_spatial_remat_ranks.py`` (two gloo ranks x 2 bands against
JAX's ``make_mesh_2d(2, 2)`` step with ``nn.remat``).
"""

import copy
import threading

import numpy as np
import pytest
import torch

from semseg_tpu_torch.models import ModelBuilder, layers, resnet
from semseg_tpu_torch.parallel import create_train_state, dropout_generator, train_step
from test_torch_spatial_train_step import _cfg, two_threads  # noqa: F401
from test_torch_spatial_zoo_train import PAIRS
from test_torch_train_step import make_batch

# (encoder, decoder, fc_dim, canvas, band counts, label stride)
CASES = {
    "resnet18dilated_ppm_deepsup": ("resnet18dilated", "ppm_deepsup", 512, (64, 64), (2, 4),
                                    8),
    "resnet18_upernet": (*PAIRS["resnet18_upernet"][:4], (2,), 4),
}


def _steps(c, model, bands, hw, stride):
    """Two split steps; returns (per step (loss, acc, recomputes), model)."""
    state = create_train_state(c, model, spatial_devices=["cpu"] * bands)
    out = []
    for i, seed in enumerate((1, 2)):
        b = make_batch(seed, hw=hw, ds=stride)
        before = resnet.RECOMPUTES
        m = train_step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                       dropout_generator(0, i))
        out.append((float(m["loss"]), float(m["acc"]), resnet.RECOMPUTES - before))
    return out, model


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_remat_equals_split_plain_bit_for_bit(case):
    encoder, decoder, fc_dim, hw, bands, stride = CASES[case]
    c = _cfg(encoder, decoder, fc_dim)
    model = ModelBuilder.build_model(c, device="cpu", seed=0).to(torch.float64).train()
    c.TPU.remat = True
    remat_model = ModelBuilder.build_model(c, device="cpu", seed=0).to(torch.float64).train()
    remat_model.load_state_dict(model.state_dict())
    blocks = sum(isinstance(m, resnet.ResBlock) for m in remat_model.modules())
    assert blocks == 8 and all(m.remat for m in remat_model.modules()
                               if isinstance(m, resnet.ResBlock))
    for n in bands:
        plain, ref = _steps(c, copy.deepcopy(model), n, hw, stride)
        remat, got = _steps(c, copy.deepcopy(remat_model), n, hw, stride)
        assert [s[:2] for s in remat] == [s[:2] for s in plain], n
        assert [s[2] for s in plain] == [0, 0]
        assert [s[2] for s in remat] == [blocks, blocks], n  # once per block and step
        params = dict(ref.named_parameters())
        for k, p in got.named_parameters():
            assert torch.equal(p, params[k]), f"{n} bands: {k}"
            assert torch.equal(p.grad, params[k].grad), f"{n} bands: {k} (gradient)"
        buffers = dict(ref.named_buffers())
        for k, b in got.named_buffers():
            assert torch.equal(b, buffers[k]), f"{n} bands: {k}"
        np.testing.assert_allclose(float(got.encoder.layer4[1].bn2._running_iter),
                                   (1 * 0.999 + 1) * 0.999 + 1, rtol=1e-12)


@pytest.mark.parametrize("encoder,decoder", [("hrnetv2", "c1"),
                                             ("mobilenetv2dilated", "c1_deepsup")])
def test_hrnet_and_mobilenet_take_no_checkpoint(encoder, decoder):
    c = _cfg(encoder, decoder, 720 if encoder == "hrnetv2" else 320)
    c.TPU.remat = True
    model = ModelBuilder.build_model(c, device="cpu", seed=0).train()
    assert not [m for m in model.modules() if getattr(m, "remat", False)]
    blocks = [m for m in model.modules() if isinstance(m, resnet.ResBlock)]
    assert bool(blocks) == (encoder == "hrnetv2")  # HRNet's branches are ResBlocks
    assert not any(b.takes_checkpoint() for b in blocks)


def test_the_recompute_runs_where_all_the_bands_gradients_join(monkeypatch):
    """Each block's recompute runs inside the backward of its
    ``_RecomputeFirst`` node, the one node that takes every band's output
    gradient: over bands on several cards no card's thread can enter it
    before, or beside, another (autograd runs each card's nodes on a
    thread of its own)."""
    inside, seen = threading.local(), []
    backward = resnet._RecomputeFirst.backward

    def joined(ctx, *grads):
        inside.on = True
        try:
            return backward(ctx, *grads)
        finally:
            inside.on = False

    real = layers.in_recompute

    def recomputing():
        on = real()
        if on:
            seen.append(getattr(inside, "on", False))
        return on

    monkeypatch.setattr(resnet._RecomputeFirst, "backward", staticmethod(joined))
    monkeypatch.setattr(resnet, "in_recompute", recomputing)
    c = _cfg("resnet18dilated", "c1_deepsup", 512)
    c.TPU.remat = True
    model = ModelBuilder.build_model(c, device="cpu", seed=0).to(torch.float64).train()
    b = make_batch(3)
    loss, _ = model(torch.from_numpy(b["img_data"]).double().permute(0, 3, 1, 2),
                    seg_label=torch.from_numpy(b["seg_label"]).long(), spatial=["cpu"] * 4)
    before = resnet.RECOMPUTES
    loss.backward()
    assert resnet.RECOMPUTES - before == 8 and seen == [True] * 8
