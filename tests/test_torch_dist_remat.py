"""``TPU.remat`` under the unsplit data-parallel step, on the CPU in float64:
two gloo ranks (``test_torch_dist_ranks.remat_rank``) against JAX's
``make_mesh(2)`` + ``shard_batch`` + ``train_step`` built with ``TPU.remat``
(its ``nn.remat`` on each ``ResBlock``), through
``test_torch_dist_train_step.check_two_ranks_against_jax``: that test's
batches and limits (loss rtol 1e-8, parameters and statistics atol 1e-6),
bit-equal ranks.

Each rank first runs the same two steps without remat. A checkpoint's
recompute replays the totals its forward's batch norms all-reduced
(``ops.norm.replaying``), so a rank issues as many ``dist.all_reduce``
calls a step with remat as without, and its state after the two steps is
the one without remat, bit for bit. A file of its own, so that it runs
beside ``test_torch_dist_train_step.py``.
"""

import jax

import test_torch_dist_train_step as dist_step
from test_torch_dist_ranks import remat_rank


def test_two_ranks_with_remat_match_jax_remat_data_parallel_step(monkeypatch, tmp_path):
    monkeypatch.setattr(dist_step, "train_rank", remat_rank)
    with jax.enable_x64(True):
        ranks = dist_step.check_two_ranks_against_jax(monkeypatch, str(tmp_path), grad_accum=1,
                                                      seed=11, remat=True)
    dist_step.check_remat_against_plain(ranks, str(tmp_path))
