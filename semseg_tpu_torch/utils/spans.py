"""Named spans on the profiler's clock.

``span(name)`` is a ``torch.profiler.record_function`` range when the
profiler records the calling thread, and a shared no-op context otherwise:
an unguarded ``record_function`` costs ~10 µs a use with no profiler
running, the check under 1 µs, and a program traced for export
(``serving.py``) gains no profiler operator. The profiler records the
thread that started it and autograd's threads, so a span goes on the
thread that does the work, never on a helper thread.

Spans: the batched engines' phases (``engine.py``), each ``BatchNorm2d``
and ``Conv2d`` forward (``models/layers.py``), the trainer's wait for a
batch (``parallel/mesh.device_prefetch``) and the train step's parts
(``parallel/train_step.py``); ``PERF.md`` §3 lists them with what reads
each.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A profiler range called ``name`` while the profiler records this
    thread; else a no-op context."""
    if _recording():
        return torch.profiler.record_function(name)
    return _OFF
