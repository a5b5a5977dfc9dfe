"""Device ops launched inside the program's spans, for spans that open
thousands of times in a traced stretch (``semseg::bn`` and
``semseg::conv`` once a layer call: ~4,000-4,700 each in an evaluation
cell's call).

``inside(w, name)`` is the set ``trace.Window.under(name)`` returns, found
in O(ops × log ranges): the ranges of the name on each thread are merged
into disjoint intervals, and each launch is looked up among them.
``Window.under`` walks back through every earlier range of the name for a
launch outside them, which took minutes a traced call at those counts.
"""

from __future__ import annotations

import bisect
from typing import Dict, List

from h100_bench.trace import Op, Window


def inside(w: Window, name: str) -> List[Op]:
    """The device ops launched inside a host range called ``name`` on the
    launching thread, in ``w.device``'s order."""
    merged: Dict[object, List[List[float]]] = {}
    for r in w.ranges(name):  # in start order
        spans = merged.setdefault(r.tid, [])
        if spans and r.start <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], r.end)
        else:
            spans.append([r.start, r.end])
    starts = {tid: [s for s, _ in spans] for tid, spans in merged.items()}
    out = []
    for o in w.device:
        spans = merged.get(o.tid)
        if not spans or o.launch is None:
            continue
        j = bisect.bisect_right(starts[o.tid], o.launch) - 1
        if j >= 0 and o.launch <= spans[j][1]:
            out.append(o)
    return out
