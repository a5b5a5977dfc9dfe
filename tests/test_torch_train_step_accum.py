"""The port's train step against the JAX package's, on the CPU, in float64:
``grad_accum=2`` and the c1_deepsup decoder, with the set-up, checks and
limits of ``test_torch_train_step.py`` (a file of its own so that the two
run side by side)."""

import jax
import pytest

from semseg_tpu.models import decoders as jax_decoders
from semseg_tpu.parallel.train_step import stack_microbatches as jax_stack

from semseg_tpu_torch.parallel import stack_microbatches
from test_torch_train_step import (
    _NoDropout,
    build_pair,
    check_metrics,
    check_params,
    jax_variables,
    make_batch,
    run_jax,
    run_port,
)


@pytest.fixture(autouse=True)
def x64():
    with jax.enable_x64(True):
        yield


def test_grad_accum_two_steps_match_jax(monkeypatch):
    """grad_accum=2 against JAX train_step(grad_accum=2): two microbatches
    of 2 in order, each normalised with its own batch statistics (which
    advance the running ones in order), their gradients averaged into one
    update."""
    monkeypatch.setattr(jax_decoders, "Dropout2d", _NoDropout)
    jstate, state = build_pair(jax_variables())
    batches = [make_batch(7, n=4), make_batch(8, n=4)]
    jstate, ref = run_jax(jstate, [jax_stack(b, 2) for b in batches], grad_accum=2)
    check_metrics(run_port(state, [stack_microbatches(b, 2) for b in batches], 2), ref)
    check_params(jstate, state, "ppm_deepsup")
    it = float(state.model.encoder.bn1._running_iter)
    assert abs(it - (((1 * 0.999 + 1) * 0.999 + 1) * 0.999 + 1) * 0.999 - 1) < 1e-5


def test_c1_deepsup_two_steps_match_jax():
    """No dropout in C1DeepSup, so JAX runs unpatched; the deep-supervision
    branch (off conv4) enters the loss at TRAIN.deep_sup_scale."""
    jstate, state = build_pair(jax_variables("c1_deepsup"), "c1_deepsup")
    assert state.model.deep_sup_scale == 0.4
    batches = [make_batch(3), make_batch(4)]
    jstate, ref = run_jax(jstate, batches)
    check_metrics(run_port(state, batches), ref)
    check_params(jstate, state, "c1_deepsup")
