"""The hybrid data x spatial train step (``cli.train TPU.spatial``) on the
CPU, in float64.

* In one process, the small config of ``test_torch_train_step.py``
  (resnet18dilated + ppm_deepsup, fc_dim 512, batch 2, 64x64, dropout on at
  the config's rate from the step's generator): two steps with each image's
  height split in 2 and in 4 bands (bands of 2 stride-8 rows) against the
  port's unsplit step, which ``test_torch_train_step.py`` holds to JAX's at
  1e-8. Parameters and statistics are float64 here: with float32 ones a
  gradient that differs in its last float64 bits can round its update to
  another float32 value, and the second step then moves by ~1e-8. Compared:
  loss and accuracy at each step (rtol 1e-10) and every parameter and BN
  buffer after step 2 (atol 1e-9: the running statistics after a 3x3 conv
  over 2560 channels, whose sums run in another order per band, moved by
  up to 1.2e-10 on this CPU); ``iter`` advanced twice.
* Two gloo ranks, each one data group of 2 bands, against JAX's
  ``make_mesh_2d(2, 2)`` + ``shard_batch`` + ``train_step`` (the JAX
  package's own hybrid check is ``tests/test_train_step.py:198-233``), with
  ``test_torch_dist_train_step.py``'s batches, limits (loss rtol 1e-8,
  parameters and statistics atol 1e-6), float64 weights and bit-equal ranks:
  that test's check, with its ranks' train state split
  (``test_torch_spatial_ranks``) and JAX's mesh the hybrid one.
* mobilenetv2dilated + c1_deepsup split in 2 against its unsplit step, as
  the first case (no JAX).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from semseg_tpu.parallel import make_mesh_2d

import test_torch_dist_train_step as dist_step
from semseg_tpu_torch.config import cfg as default_cfg
from semseg_tpu_torch.models import ModelBuilder
from semseg_tpu_torch.parallel import create_train_state, dropout_generator, train_step
from test_torch_spatial_ranks import spatial_train_rank
from test_torch_train_step import make_batch

LOSS_RTOL = 1e-10
STATE_ATOL = 1e-9


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: as fast as eight on an idle 8-core CPU
    (measured 11.5 / 4.1 s against 9.9 / 4.3 s for the two split cases),
    and far less slowed where other test processes share the cores (under
    six pytest workers, eight threads took 162 / 306 s)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfg(encoder, decoder, fc_dim):
    c = default_cfg.clone()
    c.MODEL.arch_encoder = encoder
    c.MODEL.arch_decoder = decoder
    c.MODEL.fc_dim = fc_dim
    c.TRAIN.num_epoch = 2
    c.TRAIN.epoch_iters = 10
    c.TPU.compute_dtype = "float64"
    return c


def _two_steps(cfg, model, bands):
    """Two steps of the port's train step, split in ``bands`` CPU bands (1:
    unsplit). Returns (metrics, the state dict)."""
    state = create_train_state(cfg, model, spatial_devices=["cpu"] * bands)
    assert state.spatial == ([torch.device("cpu")] * bands if bands > 1 else None)
    metrics = []
    for i, seed in enumerate((1, 2)):
        b = make_batch(seed)
        m = train_step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                       dropout_generator(0, i))
        metrics.append((float(m["loss"]), float(m["acc"])))
    assert state.step == 2
    return metrics, model.state_dict()


@pytest.mark.parametrize("encoder,decoder,fc_dim,bands", [
    ("resnet18dilated", "ppm_deepsup", 512, (2, 4)),
    ("mobilenetv2dilated", "c1_deepsup", 320, (2,)),
], ids=["resnet18dilated_ppm_deepsup", "mobilenetv2dilated_c1_deepsup"])
def test_split_steps_match_the_unsplit_step(encoder, decoder, fc_dim, bands):
    cfg = _cfg(encoder, decoder, fc_dim)
    model = ModelBuilder.build_model(cfg, device="cpu", seed=0).to(torch.float64).train()
    ref_metrics, ref = _two_steps(cfg, copy.deepcopy(model), 1)
    for n in bands:
        metrics, got = _two_steps(cfg, copy.deepcopy(model), n)
        for (gl, ga), (rl, ra) in zip(metrics, ref_metrics):
            np.testing.assert_allclose(gl, rl, rtol=LOSS_RTOL)
            np.testing.assert_allclose(ga, ra, rtol=LOSS_RTOL)
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=STATE_ATOL, rtol=0,
                                       err_msg=f"{n} bands: {k}")
    np.testing.assert_allclose(float(got["encoder.features.0.1._running_iter"
                                         if encoder.startswith("mobilenet")
                                         else "encoder.bn1._running_iter"]),
                               (1 * 0.999 + 1) * 0.999 + 1, rtol=1e-12)


@pytest.fixture
def x64():
    with jax.enable_x64(True):
        yield


def test_two_ranks_of_two_bands_match_jax_hybrid_mesh(x64, monkeypatch, tmp_path):
    monkeypatch.setattr(dist_step, "train_rank", spatial_train_rank)
    monkeypatch.setattr(dist_step, "make_mesh", lambda n: make_mesh_2d(n, 2))
    ranks = dist_step.check_two_ranks_against_jax(monkeypatch, str(tmp_path), grad_accum=1,
                                                  seed=11)
    it = ranks[0]["encoder"]["bn1._running_iter"]
    np.testing.assert_allclose(float(it), (1 * 0.999 + 1) * 0.999 + 1, rtol=1e-7)
