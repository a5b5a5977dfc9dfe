"""The port's data-parallel train step on two gloo ranks against the JAX
package's data-parallel step, on the CPU in float64.

The small config of ``test_torch_train_step.py`` (resnet18dilated +
ppm_deepsup, fc_dim 512, dropout at rate 0 on both sides), from the same
seeded JAX weights, here with float64 parameters too: with float32 ones
each rank rounds its share of a gradient to float32 before DDP sums the
shares, where JAX's step sums in float64 and rounds once, and that alone
moves the second step's loss by 2.4e-8 relative (measured on the CPU),
above the limit below. With float64 parameters the port's two ranks agree
with its one process to 3e-12 and the frameworks' second-step losses
differ by 5.0e-9 relative, in one process as in two (measured).
The port runs two ranks at batch 1 each
(``test_torch_dist_ranks.train_rank``): the ranks hold different canvases
and different void shares, and pad to their common canvas through the
store. JAX runs ``make_mesh(2)`` + ``shard_batch`` + ``train_step`` on the
global batch, padded here with numpy. At batch 1 per rank the PPM's scale-1
branch normalises over 1 value per rank and 2 globally: JAX trains there,
so the port must too. Compared after each of two steps: the global loss and
accuracy; after step 2 every parameter and BN running mean, variance and
``iter``, and both ranks' state bit for bit. Limits are
``test_torch_train_step.py``'s: loss rtol 1e-8, parameters and statistics
atol 1e-6.

This file holds the plain step; ``test_torch_dist_train_step_accum.py``
holds ``grad_accum=2`` (a file of its own, so that the two run side by
side).
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semseg_tpu.models import ModelBuilder as JaxModelBuilder, decoders as jax_decoders
from semseg_tpu.parallel import create_train_state as jax_create_train_state
from semseg_tpu.parallel import make_mesh, replicate_state, shard_batch
from semseg_tpu.parallel import train_step as jax_train_step

from semseg_tpu_torch.models.convert import state_dicts_from_jax
from semseg_tpu_torch.parallel import stack_microbatches
from test_torch_dist_ranks import load, start, train_rank, void_labels
from test_torch_train_step import PARAM_TOL, _NoDropout, check_metrics, jax_variables, small_cfgs

PAD = {"img_data": 0.0, "seg_label": -1}


def rank_batches(seed, grad_accum):
    """Two steps' batches for each of two ranks: (H, W) canvases and void
    shares differ between the ranks at each step."""
    rng = np.random.RandomState(seed)
    n = grad_accum
    # Both steps join on a 48x56 canvas (6x7 at the PPM): one JAX compile.
    shapes = [[((48, 56), 0.1), ((40, 56), 0.5)], [((40, 56), 0.3), ((48, 40), 0.0)]]
    out = [[], []]
    for step in shapes:
        for r, ((h, w), void) in enumerate(step):
            b = {"img_data": rng.randn(n, h, w, 3).astype(np.float32),
                 "seg_label": void_labels(rng, (n, h // 8, w // 8), void)}
            out[r].append(stack_microbatches(b, grad_accum) if grad_accum > 1 else b)
    return out


def global_batch(rank_batches, microbatched):
    """The ranks' batches padded to one canvas with numpy and joined along
    the batch axis, rank 0 first."""
    lead = 2 if microbatched else 1
    out = {}
    for k, v in PAD.items():
        hw = np.max([b[k].shape[lead:lead + 2] for b in rank_batches], axis=0)
        padded = []
        for b in rank_batches:
            x = b[k]
            pad = [(0, 0)] * lead + [(0, hw[0] - x.shape[lead]), (0, hw[1] - x.shape[lead + 1])]
            padded.append(np.pad(x, pad + [(0, 0)] * (x.ndim - lead - 2), constant_values=v))
        out[k] = np.concatenate(padded, axis=lead - 1)
    return out


def run_jax_data_parallel(jstate, batches, grad_accum):
    mesh = make_mesh(2)
    jstate = replicate_state(mesh, jstate)
    step = jax.jit(functools.partial(jax_train_step, grad_accum=grad_accum))
    metrics = []
    for b in batches:
        jstate, m = step(jstate, shard_batch(mesh, b, microbatched=grad_accum > 1),
                         jax.random.PRNGKey(0))
        metrics.append((float(m["loss"]), float(m["acc"])))
    return jstate, metrics


@functools.lru_cache(maxsize=1)
def reference_weights():
    """The small JAX model's seeded variables in float64 and the port's
    state dicts of them, built once per process (``_accum.py`` shares them
    when the two files run in one)."""
    variables = jax.tree.map(lambda a: np.asarray(a, np.float64), dict(jax_variables()))
    return variables, state_dicts_from_jax(variables, "resnet18dilated", "ppm_deepsup")


def check_two_ranks_against_jax(monkeypatch, out, grad_accum, seed):
    monkeypatch.setattr(jax_decoders, "Dropout2d", _NoDropout)
    variables, weights = reference_weights()
    per_rank = rank_batches(seed, grad_accum)
    # Through a file: spawn's pipe would hold the parent until each rank had
    # started and unpickled the ~200 MB in turn.
    path = os.path.join(out, "weights.pt")
    torch.save(weights, path)
    join = start(train_rank, 2, out, {"weights": path, "batches": per_rank,
                                      "grad_accum": grad_accum})
    # JAX's step runs while the ranks do.
    jc = small_cfgs()[0]
    jstate = jax_create_train_state(jc, JaxModelBuilder.build_model(jc, dtype=jnp.float64),
                                    variables)
    batches = [global_batch(step, grad_accum > 1) for step in zip(*per_rank)]
    jstate, ref = run_jax_data_parallel(jstate, batches, grad_accum)
    join()
    os.remove(path)
    ranks = load(out)
    for r, got in enumerate(ranks):
        check_metrics(got["metrics"], ref)
        assert got["step"] == 2
        # The ranks padded to the canvas the global batch has.
        lead = 2 if grad_accum > 1 else 1
        for b, joined in zip(got["padded"], batches):
            for k in PAD:
                rows = [slice(None)] * (lead - 1) + [slice(r, r + 1)]
                np.testing.assert_array_equal(b[k], joined[k][tuple(rows)], err_msg=k)

    enc, dec = state_dicts_from_jax(
        jax.tree.map(np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}),
        "resnet18dilated", "ppm_deepsup")
    for ref_sd, part in ((enc, "encoder"), (dec, "decoder")):
        mine, other = ranks[0][part], ranks[1][part]
        assert sorted(ref_sd) == sorted(mine)
        for k, v in ref_sd.items():
            assert torch.equal(mine[k], other[k]), k
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(mine[k].numpy(), v.numpy(), err_msg=k, **PARAM_TOL)
    return ranks


@pytest.fixture(autouse=True)
def x64():
    with jax.enable_x64(True):
        yield


def test_two_ranks_match_jax_data_parallel_step(monkeypatch, tmp_path):
    ranks = check_two_ranks_against_jax(monkeypatch, str(tmp_path), grad_accum=1, seed=11)
    it = ranks[0]["encoder"]["bn1._running_iter"]
    np.testing.assert_allclose(float(it), (1 * 0.999 + 1) * 0.999 + 1, rtol=1e-7)
