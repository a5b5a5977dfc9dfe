"""The port's profiler spans (``semseg_tpu_torch.utils.spans``) on the CPU,
through a narrow float32 resnet18dilated + ppm_deepsup at a tiny size.

* With no profiler running no span enters ``record_function``: an engine
  call, a train step and ``device_prefetch`` run with it raising, and a
  program that ``serving.export_bundle`` exports holds no profiler node.
* Under ``torch.profiler.profile`` (CPU): ``batched_metrics_from_originals``
  records every ``semseg::eval.*`` span, ``semseg::levels``,
  ``semseg::bn`` and ``semseg::conv``, all on the calling thread, and each
  ``aten::convolution`` lies inside ``semseg::conv`` inside
  ``semseg::eval.model``; the host-pyramid entries (``batched_metrics``,
  ``batched_predict``) record their phases too; a train step records
  ``semseg::bn`` and ``semseg::conv`` inside ``semseg::forward``; iterating
  ``device_prefetch`` records ``semseg::data.wait`` on the consumer's
  thread.
"""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from semseg_tpu_torch.cli.eval import build_engines
from semseg_tpu_torch.config import cfg
from semseg_tpu_torch.models import ModelBuilder
from semseg_tpu_torch.parallel import (
    create_train_state,
    device_prefetch,
    dropout_generator,
    train_step,
)
from semseg_tpu_torch.utils import spans

EVAL = {f"semseg::eval.{p}" for p in ("plan", "stage", "wait", "model", "epilogue", "fetch")}
LAYERS = {"semseg::bn", "semseg::conv"}
CALLER = "test::caller"
SHAPES = [(48, 64), (64, 48), (40, 56)]


def _cfg():
    c = cfg.clone()
    c.MODEL.arch_encoder = "resnet18dilated"
    c.MODEL.arch_decoder = "ppm_deepsup"
    c.MODEL.fc_dim = 512
    c.DATASET.imgSizes = (32, 40)
    c.DATASET.imgMaxSize = 64
    c.TPU.compute_dtype = "float32"
    c.TRAIN.num_epoch = 1
    c.TRAIN.epoch_iters = 4
    return c


@pytest.fixture(scope="module")
def engine():
    torch.manual_seed(0)
    return build_engines(_cfg(), 1, batch=2, pack_buckets=True, device_pyramid=True,
                         device="cpu")[0]


@pytest.fixture(scope="module")
def chunk():
    rng = np.random.RandomState(0)
    oris = [rng.randint(0, 256, (*s, 3)).astype(np.uint8) for s in SHAPES]
    labels = [rng.randint(-1, 150, s).astype(np.int64) for s in SHAPES]
    return oris, labels


def _train_state():
    c = _cfg()
    return create_train_state(c, ModelBuilder.build_model(c, device="cpu", seed=0).train())


def _train_batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"img_data": rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8),
            "img_valid_hw": np.array([[64, 56], [48, 64]], np.int32),
            "seg_label": rng.randint(-1, 150, (2, 8, 8)).astype(np.int32)}


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _profiled(fn):
    """(``fn()``, the profile's events, the calling thread's id), ``fn``
    run under the CPU profiler inside the range ``test::caller``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALLER):
            out = fn()
    events = list(prof.events())
    (caller,) = [e for e in events if e.name == CALLER]
    return out, events, caller.thread


def _named(events, name):
    return [e for e in events if e.name == name]


def _inside(inner, outers) -> bool:
    """Whether ``inner`` lies within one of ``outers`` on its thread."""
    return any(o.thread == inner.thread and o.time_range.start <= inner.time_range.start
               and inner.time_range.end <= o.time_range.end for o in outers)


@pytest.fixture(scope="module")
def eval_profile(engine, chunk):
    return _profiled(lambda: engine.batched_metrics_from_originals(*chunk))


def test_span_is_a_shared_no_op_without_a_profiler():
    assert spans.span("semseg::a") is spans.span("semseg::b")


def test_no_span_enters_record_function_without_a_profiler(monkeypatch, engine, chunk):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    got = engine.batched_metrics_from_originals(*chunk)
    assert len(got) == len(SHAPES) and all(row[1] > 0 for row in got)
    state = _train_state()
    batches = list(device_prefetch(iter([_train_batch(0), _train_batch(1)]), "cpu"))
    for i, batch in enumerate(batches):
        metrics = train_step(state, batch, dropout_generator(0, i))
        assert torch.isfinite(metrics["loss"])
    assert state.step == 2


def test_exported_program_holds_no_profiler_op(tmp_path):
    from semseg_tpu_torch.serving import export_bundle

    model = ModelBuilder.build_model(_cfg(), device="cpu", seed=0).eval()
    manifest = export_bundle(model, str(tmp_path), shapes=[(64, 64)], batch_size=1)
    exp = torch.export.load(os.path.join(str(tmp_path), manifest["programs"][0]["file"]))
    targets = [str(n.target) for n in exp.graph.nodes if n.op == "call_function"]
    assert any("conv2d" in t for t in targets)
    assert not [t for t in targets if "profiler" in t]


def test_engine_spans_on_the_calling_thread(eval_profile):
    got, events, caller = eval_profile
    assert len(got) == len(SHAPES)
    names = {e.name for e in events}
    assert EVAL | LAYERS | {"semseg::levels"} <= names, sorted(EVAL | LAYERS - names)
    ours = [e for e in events if e.name.startswith("semseg::")]
    assert {e.thread for e in ours} == {caller}


def test_convolution_inside_conv_inside_model(eval_profile):
    _, events, _ = eval_profile
    convs, models = _named(events, "semseg::conv"), _named(events, "semseg::eval.model")
    assert convs and all(_inside(c, models) for c in convs)
    ops = _named(events, "aten::convolution")
    assert ops and all(_inside(o, convs) for o in ops)
    bns = _named(events, "semseg::bn")
    assert bns and all(_inside(b, models) for b in bns)
    # The level derivation is not the network's.
    assert not any(_inside(e, models) for e in _named(events, "semseg::levels"))


def test_host_pyramid_entries_record_their_phases(engine):
    rng = np.random.RandomState(1)
    items = [[rng.randint(0, 256, (1, h, w, 3)).astype(np.uint8) for h, w in levels]
             for levels in ([(32, 40), (40, 48)], [(40, 32)])]
    labels = [rng.randint(-1, 150, (40, 48)).astype(np.int64),
              rng.randint(-1, 150, (48, 40)).astype(np.int64)]
    for run in (lambda: engine.batched_metrics(items, labels),
                lambda: engine.batched_predict(items, [lab.shape for lab in labels]),
                lambda: engine.batched_predict(items, [lab.shape for lab in labels],
                                               device_postproc=False)):
        _, events, caller = _profiled(run)
        names = {e.name for e in events if e.thread == caller}
        assert {"semseg::eval.plan", "semseg::eval.stage", "semseg::eval.model",
                "semseg::eval.epilogue", "semseg::eval.fetch"} <= names, sorted(names)


def test_train_step_records_bn_inside_forward():
    state = _train_state()
    batch = _tensors(_train_batch())
    metrics, events, caller = _profiled(lambda: train_step(state, batch, dropout_generator(0, 0)))
    assert torch.isfinite(metrics["loss"])
    forwards = _named(events, "semseg::forward")
    assert len(forwards) == 1 and forwards[0].thread == caller
    for name in LAYERS:
        found = _named(events, name)
        assert found and all(_inside(e, forwards) for e in found), name
    assert _named(events, "semseg::backward") and _named(events, "semseg::optimizer")


def test_device_prefetch_records_the_wait():
    batches = [_train_batch(i) for i in range(3)]
    got, events, caller = _profiled(lambda: list(device_prefetch(iter(batches), "cpu")))
    assert len(got) == len(batches)
    np.testing.assert_array_equal(got[2]["img_data"].numpy(), batches[2]["img_data"])
    waits = _named(events, "semseg::data.wait")
    # One a batch, and one for the end of the feed.
    assert len(waits) == len(batches) + 1 and {e.thread for e in waits} == {caller}
