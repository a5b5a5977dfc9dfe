"""The per-layer metrics that read the program's spans: each reader on a
synthetic traced window, and every span a metric reads emitted by the
program when the tiny cells run under the profiler on the CPU (a renamed
span fails here instead of reading nothing)."""

import json
import os
import random
import re

import pytest

from h100_bench import harness
from h100_bench.spans import inside
from h100_bench.trace import Op, Window
from h100_bench.tests import tiny

CELLS = [w["name"] for w in json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
         ["workloads"]]

# Per reader: the span whose device ops it sums, and the cell kind.
DEVICE = {"eval.model_ms": ("semseg::eval.model", "eval"),
          "eval.epilogue_ms": ("semseg::eval.epilogue", "eval"),
          "eval.bn_ms": ("semseg::bn", "eval"),
          "eval.conv_ms": ("semseg::conv", "eval"),
          "train.bn_forward_ms": ("semseg::bn", "train")}
# Per reader: the spans whose host time it sums, and the cell kind.
HOST = {"eval.upload_ms": (("semseg::eval.stage", "semseg::eval.wait"), "eval"),
        "train.prefetch_wait_ms": (("semseg::data.wait",), "train")}


def _info(kind):
    return {"kind": kind, "images": 4} if kind == "eval" else {"kind": kind, "steps": 4}


def _kernel(start_us, dur_us, launch, tid=1):
    return Op("kernel_x", start_us, start_us + dur_us, "kernel", tid, launch)


@pytest.mark.parametrize("name", sorted(DEVICE))
def test_device_reader_counts_launches_inside_its_span(name):
    span, kind = DEVICE[name]
    host = [Op(span, 100.0, 200.0, "user_annotation", 1),
            Op(span, 300.0, 400.0, "user_annotation", 1),
            Op("semseg::other", 500.0, 600.0, "user_annotation", 1)]
    device = [_kernel(1000.0, 400.0, 150.0),  # inside the first range
              _kernel(1200.0, 600.0, 350.0),  # inside the second, overlapping the first
              _kernel(2000.0, 900.0, 250.0),  # between the ranges
              _kernel(3000.0, 700.0, 550.0),  # inside another range
              _kernel(4000.0, 500.0, 150.0, tid=2)]  # inside in time, another thread
    read = harness.metric_reader(name)
    # The union of the two launched inside, 1000-1800 us, over 4 images or steps.
    assert read(Window(device, host, 1.0, _info(kind))) == pytest.approx(0.8 / 4)
    other = "train" if kind == "eval" else "eval"
    assert read(Window(device, host, 1.0, _info(other))) is None
    assert read(Window(device, host[2:], 1.0, _info(kind))) is None


@pytest.mark.parametrize("name", sorted(HOST))
def test_host_reader_sums_its_spans(name):
    spans, kind = HOST[name]
    host = [Op(spans[0], 100.0, 400.0, "user_annotation", 1),
            Op(spans[-1], 1000.0, 1100.0, "user_annotation", 1),
            Op("semseg::eval.model", 400.0, 1000.0, "user_annotation", 1),
            Op("aten::copy_", 150.0, 250.0, "cpu_op", 1)]
    read = harness.metric_reader(name)
    # 300 + 100 us of its spans, over 4 images or steps.
    assert read(Window([], host, 1.0, _info(kind))) == pytest.approx(0.4 / 4)
    other = "train" if kind == "eval" else "eval"
    assert read(Window([], host, 1.0, _info(other))) is None
    assert read(Window([], host[2:], 1.0, _info(kind))) is None


def test_inside_finds_what_under_finds():
    """``spans.inside`` against ``Window.under`` on ranges that overlap,
    nest and touch, on two threads, with launches on a third, at the
    ranges' ends and with none."""
    rng = random.Random(3)
    host = [Op("semseg::x", 100.0, 5000.0, "user_annotation", 1),
            Op("semseg::y", 0.0, 20000.0, "user_annotation", 1)]
    for tid in (1, 2):
        t = 0.0
        for _ in range(300):
            t += rng.uniform(0.0, 50.0)
            host.append(Op("semseg::x", t, t + rng.choice([0.0, 20.0, 80.0]),
                           "user_annotation", tid))
    ends = [t for r in host for t in (r.start, r.end)]
    device = []
    for i in range(4000):
        launch = rng.choice(ends) if i % 4 == 0 else rng.uniform(-100.0, 16000.0)
        device.append(_kernel(float(i), 1.0, None if i % 50 == 0 else launch,
                              tid=rng.choice((1, 2, 3))))
    w = Window(device, host, 1.0, {})
    found = inside(w, "semseg::x")
    assert {id(o) for o in found} == {id(o) for o in w.under("semseg::x")}
    assert len(found) == len({id(o) for o in found}) and 1000 < len(found) < 3000


def _spans_read(metric: str) -> set:
    with open(os.path.join(harness.BENCH, "metrics", metric + ".py")) as f:
        return set(re.findall(r"semseg::[A-Za-z0-9_.]*[A-Za-z0-9_]", f.read()))


def _emitted(cell: harness.Cell, seed: int) -> set:
    """The names of the host ranges the program emits when a stretch of
    the cell runs under the profiler on the CPU (one call, two steps)."""
    from torch.profiler import ProfilerActivity, profile

    from h100_bench.drivers import eval_ms, train

    if cell.driver == "eval_ms":
        engine, chunks = eval_ms.build(cell, seed, "cpu")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            engine.batched_metrics_from_originals(*chunks[0])
    else:
        trainer = train.Trainer(cell, seed, "cpu")
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                trainer.step()
                trainer.step()
            trainer.fetch()
        finally:
            trainer.close()
    return {e.name for e in prof.events()}


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_emits_every_span_its_metrics_read(cell):
    c = tiny.tiny(cell)
    wanted = set().union(*(_spans_read(m["name"]) for m in c.per_layer))
    assert wanted, cell
    missing = wanted - _emitted(c, 2**31 + 5)
    assert not missing, (cell, sorted(missing))
