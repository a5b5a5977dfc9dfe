"""The port's batched engine against the JAX package's, on the CPU.

* The epilogue (``_accum_fn``, ``_argmax_fn``, ``_metrics_fn``) on seeded
  logits and labels: score canvas within atol 1e-5 (float32, summation
  order), argmax maps and packed metric vectors equal.
* Grouping (``_pack_groups``) gives JAX's groups on the shape sets of
  ``tests/test_bucket_packing.py``.
* ``batched_metrics`` over a packed step-8 run of the narrow float32 model
  gives JAX ``BatchedInferenceEngine.batched_metrics``'s packed vectors,
  with identical argmax maps.
* The chunk loop: a tight canvas budget changes no metric, device and host
  post-processing agree, device metrics equal the host metrics of the
  predicted maps, and the uploader thread stops when its consumer raises.
* The eval CLI with no ``--exact`` runs end to end on the CPU, batched and
  per image.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semseg_tpu.engine import BatchedInferenceEngine as JaxBatchedEngine
from semseg_tpu.utils import accuracy, intersectionAndUnion

from semseg_tpu_torch.cli import eval as eval_cli
from semseg_tpu_torch.engine import BatchedInferenceEngine, InferenceEngine

from test_torch_engine import CFG, SMALL, _val_set, reference_pth  # noqa: F401
from test_torch_model import narrow_jax_model, narrow_port_model

C = 150


def _epilogue_engines():
    kw = dict(num_class=C, output_stride=8, bucket_step=8)
    return (BatchedInferenceEngine(None, device="cpu", **kw),
            JaxBatchedEngine(None, None, bucket_denylist=(), **kw))


@pytest.mark.parametrize("hv,wv,H,W", [(8, 10, 61, 77), (5, 7, 37, 50), (8, 10, 64, 80),
                                       (1, 1, 9, 11)])
def test_accum_fn_matches_jax(hv, wv, H, W):
    port, ref = _epilogue_engines()
    rng = np.random.RandomState(hv * W)
    Hp, Wp = port._bucket_key(H, W)
    acc = rng.rand(Hp, Wp, C).astype(np.float32)
    logits = (rng.randn(8, 10, C) * 3).astype(np.float32)
    want = np.asarray(ref._accum_fn(jnp.asarray(acc), jnp.asarray(logits), hv, wv, H, W))
    got = port._accum_fn(torch.from_numpy(acc.copy()),
                         torch.from_numpy(logits).permute(2, 0, 1), hv, wv, H, W)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_argmax_and_metrics_match_jax():
    port, ref = _epilogue_engines()
    rng = np.random.RandomState(11)
    acc = rng.rand(40, 48, C).astype(np.float32)
    # Void (255), in-range classes, and ids >= num_class (counted as
    # labelled pixels, in neither histogram).
    label = rng.randint(0, C, (40, 48)).astype(np.uint8)
    label[rng.rand(40, 48) < 0.2] = 255
    label[rng.rand(40, 48) < 0.05] = 200
    pred = acc.argmax(-1)
    label[rng.rand(40, 48) < 0.3] = pred[rng.rand(40, 48) < 0.3][0]  # some hits
    label[:5, :5] = pred[:5, :5]
    np.testing.assert_array_equal(port._argmax_fn(torch.from_numpy(acc)).numpy(),
                                  np.asarray(ref._argmax_fn(jnp.asarray(acc))))
    got = port._metrics_fn(torch.from_numpy(acc), torch.from_numpy(label))
    want = np.asarray(ref._metrics_fn(jnp.asarray(acc), jnp.asarray(label)))
    assert got.dtype == torch.float32 and got.shape == (2 + 2 * C,)
    assert got[0] >= 25
    np.testing.assert_array_equal(got.numpy(), want)


def _groups_of(shape_counts):
    return {(h, w): [(i, np.zeros((1, h, w, 3), np.uint8), h, w) for i in range(n)]
            for (h, w), n in shape_counts}


@pytest.mark.parametrize("shape_counts,uncapped", [
    ([((96, 128), 1), ((304, 400), 3)], True),
    ([((96, 128), 4), ((304, 400), 4)], True),
    ([((96, 416), 1), ((304, 400), 3)], True),
    ([((64, 64), 1), ((96, 128), 1), ((304, 400), 2)], True),
    ([((96, 128), 1), ((304, 400), 3)], False),
    ([((288, 384), 1), ((304, 400), 3)], False),
    ([((288, 384), 5), ((296, 392), 2), ((304, 400), 3), ((200, 200), 1)], False),
], ids=["spare-slot", "full-batches", "non-covering", "chain", "area-cap", "adjacent",
        "mixed"])
def test_pack_groups_matches_jax(shape_counts, uncapped):
    port, ref = _epilogue_engines()
    for eng in (port, ref):
        eng.pack_buckets, eng.batch_size = True, 4
        if uncapped:
            eng.pack_max_area_ratio, eng.pack_max_pad_px = float("inf"), 1 << 30
    got = port._pack_groups(_groups_of(shape_counts))
    want = ref._pack_groups(_groups_of(shape_counts))
    assert {k: [t[0] for t in v] for k, v in got.items()} == \
        {k: [t[0] for t in v] for k, v in want.items()}


def _narrow_engines(**kw):
    jax_model, variables = narrow_jax_model()
    kw = dict(num_class=C, output_stride=8, bucket_step=8, batch_size=2, **kw)
    port = BatchedInferenceEngine(narrow_port_model(variables), device="cpu", **kw)
    ref = JaxBatchedEngine(jax_model, variables, bucket_denylist=(), **kw)
    return port, ref


def _items(seed):
    """Five images, two lattice levels each: when packing, the (56, 72)
    level folds into the spare slot of the (64, 80) bucket, and the
    (32, 40) bucket ends in a padded chunk."""
    rng = np.random.RandomState(seed)
    shapes = [[(64, 80), (32, 40)], [(56, 72), (32, 40)], [(64, 80), (40, 48)],
              [(64, 80), (24, 32)], [(48, 56), (32, 40)]]
    items = [[rng.randint(0, 256, (1, h, w, 3)).astype(np.uint8) for h, w in levels]
             for levels in shapes]
    labels = [rng.randint(-1, C, (61 + i, 77 - i)).astype(np.int32) for i in range(5)]
    return items, labels


def test_batched_metrics_match_jax():
    port, ref = _narrow_engines(pack_buckets=True)
    items, labels = _items(13)
    groups = port._group_by_bucket(items)
    assert (56, 72) not in groups and len(groups[(64, 80)]) == 4
    assert len(groups[(32, 40)]) == 3
    got = port.batched_metrics(items, labels)
    want = ref.batched_metrics(items, labels)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    seg_sizes = [lab.shape for lab in labels]
    for a, b in zip(port.batched_predict(items, seg_sizes), ref.batched_predict(items, seg_sizes)):
        np.testing.assert_array_equal(a, b)


def test_batched_engine_drives_the_valid_form(monkeypatch):
    """Every chunk's forward hands the model its (B, 2) int32 extents."""
    port, _ = _narrow_engines(pack_buckets=True)
    items, labels = _items(14)
    seen = []
    forward = port.model.decoder.forward

    def spy(conv_out, seg_size=None, valid_hw=None):
        seen.append(valid_hw[-1].clone())
        return forward(conv_out, seg_size, valid_hw)

    monkeypatch.setattr(port.model.decoder, "forward", spy)
    port.batched_metrics(items, labels)
    groups = port._group_by_bucket(items)
    assert len(seen) == sum(-(-len(t) // 2) for t in groups.values())
    for v in seen:
        assert v.dtype == torch.int32 and v.shape == (2, 2)


def test_device_metrics_equal_host_metrics_of_the_maps():
    port, _ = _narrow_engines(pack_buckets=True)
    items, labels = _items(15)
    dev = port.batched_metrics(items, labels)
    preds = port.batched_predict(items, [lab.shape for lab in labels])
    for (a_s, p_s, d_inter, d_union), pred, lab in zip(dev, preds, labels):
        acc, pix = accuracy(pred, lab)
        inter, union = intersectionAndUnion(pred, lab, C)
        assert int(p_s) == int(pix) and int(a_s) == round(acc * int(pix))
        np.testing.assert_array_equal(d_inter.astype(np.int64), inter)
        np.testing.assert_array_equal(d_union.astype(np.int64), union)


def test_device_and_host_postproc_agree():
    port, _ = _narrow_engines()
    items, labels = _items(16)
    seg_sizes = [lab.shape for lab in labels]
    on_dev = port.batched_predict(items, seg_sizes, device_postproc=True)
    on_host = port.batched_predict(items, seg_sizes, device_postproc=False)
    for a, b, hw in zip(on_dev, on_host, seg_sizes):
        assert a.shape == b.shape == hw
        assert (a == b).mean() > 0.999


def test_batched_agrees_with_per_image_engine():
    """Without packing a batched task is padded no more than a per-image
    one (packing widens the pad border, a known drift of its own)."""
    port, _ = _narrow_engines()
    single = InferenceEngine(port.model, device="cpu", exact=False, bucket_step=8)
    items, labels = _items(17)
    seg_sizes = [lab.shape for lab in labels]
    for pred, pyr, hw in zip(port.batched_predict(items, seg_sizes), items, seg_sizes):
        assert (pred == single.predict(pyr, hw)).mean() > 0.999


def test_tight_canvas_budget_changes_no_metric():
    port, _ = _narrow_engines()
    tight = BatchedInferenceEngine(port.model, device="cpu", num_class=C, bucket_step=8,
                                   batch_size=2, canvas_budget_mb=1)
    items, labels = _items(18)
    assert len(tight._canvas_windows([lab.shape for lab in labels], range(5))) == 5
    for a, b in zip(port.batched_metrics(items, labels), tight.batched_metrics(items, labels)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_degenerate_inputs():
    port, _ = _epilogue_engines()
    assert port.batched_metrics([], []) == []
    assert port.batched_predict([], []) == []
    with pytest.raises(ValueError, match="level"):
        port.batched_metrics([[]], [np.zeros((8, 8), np.int32)])


def test_uploader_thread_unblocks_when_consumer_dies():
    port, _ = _epilogue_engines()
    tasks = [(i, np.zeros((1, 16, 16, 3), np.uint8), 16, 16) for i in range(8)]

    def forward_chunk(key, padded, staged=None):
        raise RuntimeError("forward failed")

    with pytest.raises(RuntimeError, match="forward failed"):
        port._accumulate_on_device(
            {i: (16, 16) for i in range(8)}, {(16, 16): tasks}, {i: 1 for i in range(8)},
            forward_chunk, lambda i, acc: None, stage_chunk=lambda key, padded: object(),
        )
    deadline = time.time() + 10
    while any(t.name == "chunk-uploader" and t.is_alive() for t in threading.enumerate()):
        assert time.time() < deadline, "chunk-uploader thread still alive"
        time.sleep(0.05)


def test_uploader_error_reaches_the_consumer():
    port, _ = _epilogue_engines()
    tasks = [(i, np.zeros((1, 16, 16, 3), np.uint8), 16, 16) for i in range(8)]

    def stage_chunk(key, padded):
        raise OSError("staging failed")

    with pytest.raises(OSError, match="staging failed"):
        port._accumulate_on_device(
            {i: (16, 16) for i in range(8)}, {(16, 16): tasks}, {i: 1 for i in range(8)},
            lambda *a: None, lambda i, acc: None, stage_chunk=stage_chunk,
        )


@pytest.mark.parametrize("batch", ["2", "0"])
def test_eval_cli_default_runs(reference_pth, tmp_path, batch):  # noqa: F811
    """No ``--exact``: the batched engine (packing on) at ``--batch 2``, the
    bucketed per-image engine at ``--batch 0``. The labels alone decide the
    pixel count, so both runs count the same."""
    data = _val_set(tmp_path, [(48, 64), (56, 40), (48, 60), (41, 64)], seed=9)
    miou, acc, iou, raw = eval_cli.main([
        "--cfg", CFG, "--device", "cpu", "--batch", batch, "--metrics-out",
        str(tmp_path / "m.npz"), "DIR", str(reference_pth), *data, *SMALL,
    ])
    assert 0.0 <= miou <= 1.0 and 0.0 <= acc <= 1.0 and iou.shape == (C,)
    labels = [np.asarray(__import__("PIL.Image").Image.open(tmp_path / f"{i}.png"),
                         np.int64) - 1 for i in range(4)]
    assert raw["pix_count"] == sum(int((lab >= 0).sum()) for lab in labels)
    saved = np.load(tmp_path / "m.npz")
    assert float(saved["pix_count"]) == raw["pix_count"]
