"""``grad_accum=2`` on two gloo ranks against JAX's data-parallel
``train_step(grad_accum=2)``, with the set-up, checks and limits of
``test_torch_dist_train_step.py`` (a file of its own so that the two run
side by side): each rank holds two microbatches of 1 on its own canvas; a
global microbatch is both ranks' microbatch of that index (JAX's (K, N)
layout with N sharded), normalised with its own global statistics, and
DDP all-reduces the gradients once per step."""

import jax
import numpy as np
import pytest

from test_torch_dist_train_step import check_two_ranks_against_jax


@pytest.fixture(autouse=True)
def x64():
    with jax.enable_x64(True):
        yield


def test_two_ranks_grad_accum_match_jax_data_parallel_step(monkeypatch, tmp_path):
    ranks = check_two_ranks_against_jax(monkeypatch, str(tmp_path), grad_accum=2, seed=12)
    it = float(ranks[0]["encoder"]["bn1._running_iter"])
    np.testing.assert_allclose(it, (((1 * 0.999 + 1) * 0.999 + 1) * 0.999 + 1) * 0.999 + 1,
                               rtol=1e-7)
