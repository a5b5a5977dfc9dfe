"""A run with its timed path broken underneath must come out not correct.

Each test skips the look for a card and drives the rest of a run of a
tiny cell on the CPU, the program in float64 (its sound runs read nothing
but rounding), once sound and once with one fault that the cell can have:
an answer altered where it is produced, half of the batch left out, a
step that returns its state unchanged."""

import pytest

from h100_bench.drivers import eval_ms, train
from h100_bench.tests import tiny

EVAL = ["r50d-ppm.eval-ms", "r50-upernet.eval-ms"]


def _correct(out) -> bool:
    return all(c.ok for c in out["checks"])


@pytest.mark.parametrize("cell", EVAL)
def test_sound_eval_run_is_correct(monkeypatch, cell):
    assert _correct(eval_ms.run(tiny.tiny(cell, float64=True), 21, 0.0, False, "cpu"))


@pytest.mark.parametrize("cell", EVAL)
def test_eval_answer_altered(monkeypatch, cell):
    """Each image's predictions shifted by one class where the counts are made."""
    from semseg_tpu_torch.engine import BatchedInferenceEngine

    made = BatchedInferenceEngine._metrics_fn
    monkeypatch.setattr(BatchedInferenceEngine, "_metrics_fn",
                        lambda self, acc, label: made(self, acc.roll(1, -1), label))
    assert not _correct(eval_ms.run(tiny.tiny(cell, float64=True), 21, 0.0, False, "cpu"))


@pytest.mark.parametrize("cell", EVAL)
def test_eval_half_of_the_batch_left_out(monkeypatch, cell):
    """Every other slot's level is left out of its image's scores."""
    from semseg_tpu_torch.engine import BatchedInferenceEngine

    accum = BatchedInferenceEngine._accum_fn
    calls = [0]

    def half(self, acc, *a, **kw):
        calls[0] += 1
        return acc if calls[0] % 2 else accum(self, acc, *a, **kw)

    monkeypatch.setattr(BatchedInferenceEngine, "_accum_fn", half)
    assert not _correct(eval_ms.run(tiny.tiny(cell, float64=True), 21, 0.0, False, "cpu"))


def test_sound_train_run_is_correct(monkeypatch):
    assert _correct(train.run(tiny.tiny("r50d-ppm.train-b8", float64=True), 22, 0.0, False,
                              "cpu"))


def _broken_step(monkeypatch, wrap):
    import importlib

    # The package's ``train_step`` attribute is the function; the module
    # the driver imports it from is this one.
    ts = importlib.import_module("semseg_tpu_torch.parallel.train_step")
    step = ts.train_step
    monkeypatch.setattr(ts, "train_step", wrap(step))


def test_train_state_unchanged(monkeypatch):
    """The optimizer's update skipped: the step returns its state unchanged."""

    def wrap(step):
        def unchanged(state, batch, *a, **kw):
            saved = state.optimizer.step
            state.optimizer.step = lambda *x, **y: None
            try:
                return step(state, batch, *a, **kw)
            finally:
                state.optimizer.step = saved
        return unchanged

    _broken_step(monkeypatch, wrap)
    assert not _correct(train.run(tiny.tiny("r50d-ppm.train-b8", float64=True), 22, 0.0,
                                  False, "cpu"))


def test_train_half_of_the_batch_left_out(monkeypatch):
    """Each step on the first half of its batch, the mean over it alone."""

    def wrap(step):
        def half(state, batch, *a, **kw):
            n = batch["img_data"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()}, *a, **kw)
        return half

    _broken_step(monkeypatch, wrap)
    cell = tiny.tiny("r50d-ppm.train-b8", float64=True)
    cell.traffic["batch_per_gpu"] = 4  # half of it still has batch statistics
    assert not _correct(train.run(cell, 22, 0.0, False, "cpu"))


def test_train_answer_altered(monkeypatch):
    """Every gradient doubled where the optimizer takes it."""

    def wrap(step):
        def doubled(state, batch, *a, **kw):
            saved = state.optimizer.step

            def step_doubled(*x, **y):
                for group in state.optimizer.param_groups:
                    for p in group["params"]:
                        p.grad.mul_(2.0)
                return saved(*x, **y)

            state.optimizer.step = step_doubled
            try:
                return step(state, batch, *a, **kw)
            finally:
                state.optimizer.step = saved
        return doubled

    _broken_step(monkeypatch, wrap)
    assert not _correct(train.run(tiny.tiny("r50d-ppm.train-b8", float64=True), 22, 0.0,
                                  False, "cpu"))
