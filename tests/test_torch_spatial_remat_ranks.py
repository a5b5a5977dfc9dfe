"""``TPU.remat`` under the hybrid data x spatial step across ranks, on the CPU
in float64: two gloo ranks, each one data group of 2 CPU bands
(``test_torch_spatial_ranks.spatial_remat_rank``), against JAX's
``make_mesh_2d(2, 2)`` + ``shard_batch`` + ``train_step`` built with
``TPU.remat`` (its ``nn.remat`` on each ``ResBlock`` under the hybrid mesh),
through ``test_torch_dist_train_step.check_two_ranks_against_jax``: that
test's batches and limits (loss rtol 1e-8, parameters and statistics atol
1e-6), bit-equal ranks.

Each rank first runs the same two steps without remat. A checkpoint's
recompute replays the totals its forward's batch norms all-reduced
(``ops.norm.replaying``), so a rank issues as many ``dist.all_reduce``
calls a step with remat as without, and its state after the two steps is
the one without remat, bit for bit.
"""

import jax

from semseg_tpu.parallel import make_mesh_2d

import test_torch_dist_train_step as dist_step
from test_torch_spatial_ranks import spatial_remat_rank


def test_two_ranks_of_two_bands_with_remat_match_jax_remat(monkeypatch, tmp_path):
    monkeypatch.setattr(dist_step, "train_rank", spatial_remat_rank)
    monkeypatch.setattr(dist_step, "make_mesh", lambda n: make_mesh_2d(n, 2))
    with jax.enable_x64(True):
        ranks = dist_step.check_two_ranks_against_jax(monkeypatch, str(tmp_path), grad_accum=1,
                                                      seed=11, remat=True)
    dist_step.check_remat_against_plain(ranks, str(tmp_path))
