"""The port's data-parallel pieces on two gloo ranks on the CPU, against the
JAX package over the whole batch (float64) or the port in one process.

One spawn of two ranks (``test_torch_dist_ranks.ops_rank``) computes, each
rank on its half of the global inputs:

* ``batch_norm_train`` over the group: forward, running statistics and the
  vjp against JAX's ``batch_norm_train`` (``semseg_tpu/ops/norm.py``) over
  the whole batch, including batch 1 per rank at a 1x1 map (n = 1 locally,
  2 globally: it must not raise); the weight's and bias's gradients are
  per-rank shares that sum to JAX's;
* the training forward's loss and accuracy (``SegmentationModel`` with a
  pass-through encoder and decoder, deep supervision at 0.4) against
  JAX's masked cross-entropy and ``pixel_accuracy`` over the global batch,
  with the ranks holding different void shares: each rank's loss has the
  global value and the gradient of the global loss on its rows;
* dropout: two ranks at batch 1 draw the masks of one process at batch 2;
* the canvas exchange through the store, flat and microbatched.

Limits: float64 on both sides, 1e-12 relative (the sums differ in order
only). The handshake's failure modes and the store poll run in the test
process.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semseg_tpu.ops.losses import pixel_accuracy as jax_pixel_accuracy
from semseg_tpu.ops.losses import softmax_cross_entropy_with_ignore as jax_ce
from semseg_tpu.ops.norm import batch_norm_train as jax_bn

from semseg_tpu_torch.models.layers import Dropout2d
from semseg_tpu_torch.ops.norm import batch_norm_train
from semseg_tpu_torch.parallel import distributed
from test_torch_dist_ranks import load, ops_rank, spawn, void_labels

TOL = dict(rtol=1e-12, atol=1e-12)


def _bn_case(rng, shape):
    c = shape[-1]
    return {"x": rng.randn(*shape) * 2.0 + 0.5, "dy": rng.randn(*shape),
            "w": rng.rand(c) + 0.5, "b": rng.randn(c), "rm": rng.randn(c) * 0.1,
            "rv": rng.rand(c) + 0.5, "ri": np.array([1.999])}


def _canvas_batches():
    rng = np.random.RandomState(3)

    def flat(h, w, n=2):
        return {"img_data": rng.randn(n, h, w, 3).astype(np.float32),
                "seg_label": rng.randint(0, 150, (n, h // 8, w // 8)).astype(np.int32),
                "img_valid_hw": np.full((n, 2), [h, w], np.int32)}

    def micro(h, w):
        return {"img_data": rng.randint(0, 256, (2, 1, h, w, 3)).astype(np.uint8),
                "seg_label": rng.randint(0, 150, (2, 1, h // 8, w // 8)).astype(np.int32),
                "img_valid_hw": np.full((2, 1, 2), [h, w], np.int32)}

    return [[(flat(32, 48), False), (micro(24, 40), True), (flat(16, 16), False)],
            [(flat(40, 40), False), (micro(32, 16), True), (flat(16, 16), False)]]


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    logits = rng.randn(4, 6, 7, 10) * 3.0
    labels = np.concatenate([void_labels(rng, (2, 6, 7), 0.1), void_labels(rng, (2, 6, 7), 0.6)])
    labels = np.where(labels >= 0, labels % 10, -1).astype(np.int32)
    return {"bn": {"map": _bn_case(rng, (4, 5, 6, 8)), "1x1": _bn_case(rng, (2, 1, 1, 8))},
            "loss": (logits, labels), "canvas": _canvas_batches()}


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist_ops"))
    spawn(ops_rank, 2, out, data)
    return load(out)


@pytest.fixture(autouse=True)
def x64():
    with jax.enable_x64(True):
        yield


@pytest.mark.parametrize("name", ["map", "1x1"])
def test_batch_norm_over_the_group_matches_jax_over_the_batch(ranks, data, name):
    case = data["bn"][name]
    stats = [jnp.asarray(case[k]) for k in ("rm", "rv", "ri")]
    (y, *new), vjp = jax.vjp(lambda x, w, b: jax_bn(x, w, b, *stats),
                             *(jnp.asarray(case[k]) for k in ("x", "w", "b")))
    dx, dw, db = vjp((jnp.asarray(case["dy"]),) + tuple(jnp.zeros_like(s) for s in new))
    n = case["x"].shape[0] // 2
    for r, got in enumerate(ranks):
        mine = got[name]
        np.testing.assert_allclose(mine["y"], np.asarray(y)[r * n:(r + 1) * n], **TOL)
        np.testing.assert_allclose(mine["dx"], np.asarray(dx)[r * n:(r + 1) * n], **TOL)
        for a, b in zip(mine["stats"], new):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)
    # The ranks' running statistics are bit-equal: each computes them from
    # the same all-reduced sums.
    for a, b in zip(ranks[0][name]["stats"], ranks[1][name]["stats"]):
        assert np.array_equal(a, b)
    np.testing.assert_allclose(ranks[0][name]["dw"] + ranks[1][name]["dw"], dw, **TOL)
    np.testing.assert_allclose(ranks[0][name]["db"] + ranks[1][name]["db"], db, **TOL)


def test_batch_norm_of_one_element_raises_without_a_group(data):
    case = data["bn"]["1x1"]
    x = torch.from_numpy(case["x"][:1]).permute(0, 3, 1, 2)
    stats = [torch.from_numpy(case[k]) for k in ("w", "b", "rm", "rv", "ri")]
    with pytest.raises(ValueError, match="got 1"):
        batch_norm_train(x, *stats)


def test_loss_and_accuracy_are_the_global_batch(ranks, data):
    logits, labels = data["loss"]
    lab = jnp.asarray(labels)
    loss, grad = jax.value_and_grad(
        lambda x: jax_ce(x, lab) + 0.4 * jax_ce(0.5 * x, lab))(jnp.asarray(logits))
    acc = float(jax_pixel_accuracy(jnp.asarray(logits), lab))
    # The ranks hold different void shares, so a mean of per-rank means differs.
    valid = [(labels[r * 2:(r + 1) * 2] >= 0).mean() for r in range(2)]
    assert abs(valid[0] - valid[1]) > 0.3
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["loss"]["loss"], float(loss), rtol=1e-12)
        np.testing.assert_allclose(got["loss"]["acc"], acc, rtol=1e-12)
        np.testing.assert_allclose(got["loss"]["dx"], np.asarray(grad)[r * 2:(r + 1) * 2], **TOL)


def test_dropout_of_two_ranks_is_one_process_at_the_global_batch(ranks):
    drop = Dropout2d(0.5).train()
    drop.generator = torch.Generator().manual_seed(5)
    one = drop(torch.ones(2, 64, 2, 2, dtype=torch.float64)).numpy()
    assert 0 < (one == 0).mean() < 1
    assert not np.array_equal(one[0], one[1])
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["dropout"][0], one[r])


def test_canvas_exchange_pads_to_the_ranks_maximum(ranks, data):
    pad_value = {"img_data": 0, "seg_label": -1}
    for call, ((b0, micro), (b1, _)) in enumerate(zip(*data["canvas"])):
        lead = 2 if micro else 1
        for r, b in enumerate((b0, b1)):
            got = ranks[r]["canvas"][call]
            assert sorted(got) == sorted(b)
            np.testing.assert_array_equal(got["img_valid_hw"], b["img_valid_hw"])
            for k, v in pad_value.items():
                hw = np.maximum(b0[k].shape[lead:lead + 2], b1[k].shape[lead:lead + 2])
                want = np.full(b[k].shape[:lead] + tuple(hw) + b[k].shape[lead + 2:], v,
                               b[k].dtype)
                h, w = b[k].shape[lead:lead + 2]
                want[(slice(None),) * lead + (slice(0, h), slice(0, w))] = b[k]
                assert got[k].dtype == b[k].dtype
                np.testing.assert_array_equal(got[k], want, err_msg=f"call {call} rank {r} {k}")


@pytest.mark.parametrize("process_id", [0, 1], ids=["rank0-alone", "no-rank0"])
def test_explicit_bad_handshake_raises(process_id):
    """Rank 0 with no peer, or a rank with no rank 0 to reach: a handshake
    the caller asked for never falls back to one process."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError):
        distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 2, process_id,
                               device="cpu", timeout=1)
    assert not dist.is_initialized()


@pytest.mark.parametrize("args,env", [
    (("no-port", 2, 0), {}), (("127.0.0.1:1", 2, 2), {}),
    ((None, None, None), {"SEMSEG_COORDINATOR": "127.0.0.1:1"}),
], ids=["address", "process-id", "partial-environment"])
def test_malformed_handshake_raises(args, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError):
        distributed.initialize(*args, device="cpu")


def test_store_poll_outwaits_a_slow_peer(monkeypatch):
    """The canvas exchange waits out a slow peer, raises on one that never
    posts, and passes any other store error on at once."""
    class Store:
        def __init__(self, misses):
            self.misses, self.calls = misses, 0

        def check(self, keys):
            self.calls += 1
            return self.calls > self.misses

        def get(self, key):
            return b"7,9"

    s = Store(3)
    assert distributed._kv_get_patient(s, "k") == "7,9" and s.calls == 4
    monkeypatch.setattr(distributed, "_KV_TOTAL_S", 0.05)
    with pytest.raises(TimeoutError, match="never posted"):
        distributed._kv_get_patient(Store(10**9), "k")

    class Broken:
        def check(self, keys):
            raise RuntimeError("connection reset by peer")

    with pytest.raises(RuntimeError, match="connection reset"):
        distributed._kv_get_patient(Broken(), "k")


def test_rank_helpers_in_one_process():
    assert distributed.process_count() == 1 and distributed.is_primary()
    assert distributed.global_batch_size(2) == 2
    assert distributed.local_batch_slice(2) == slice(0, 2)
