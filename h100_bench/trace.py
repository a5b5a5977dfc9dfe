"""The traced stretch of a run: a torch.profiler timeline of the card,
reduced to what the per-layer metrics read.

``profiled(stretch)`` runs ``stretch()`` under the profiler (CPU and CUDA
activities) between two CUDA events, and takes the profile again, up to
five times, while the span of its device activity is off the events' by
more than 3%: the retake rule of ``chip_smoke.py:510`` (``_profiled``),
which found an H100 profile now and then reading every kernel at 0.5-0.8x
while the events did not move.

``Window`` holds the device activity (kernels, copies, fills) with the host
thread and time of each launch, the host ranges (``record_function`` spans
and operators), and what the driver counted in the stretch and in the
untraced window before it (``info``). The profiler's own host work
lengthens a traced stretch (eval and training leave the card idle while
the host records each operator), so a share of time reads the untraced
window's time for the same work (``info["paced_s"]``), not the stretch's.
A kernel lies *under* a host range when its launch lies inside the range on
the same thread.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("user_annotation", "cpu_op")


@dataclass
class Op:
    name: str
    start: float  # us
    end: float
    cat: str = ""
    tid: object = None  # the launching host thread (device ops) or the thread
    launch: Optional[float] = None  # host time of the launch (device ops)


@dataclass
class Window:
    """A traced stretch: ``device`` ops (sorted by start), ``host`` ranges,
    ``traced_s`` (host clock, from the first launch's synchronise to the
    last's), ``info`` (driver counts: kind, images, steps, the stretch's
    work; ``paced_s``, the untraced window's time for the same work;
    ``window_flops`` and ``window_s``, the untraced window's)."""

    device: List[Op]
    host: List[Op]
    traced_s: float
    info: Dict = field(default_factory=dict)

    def kernels(self) -> List[Op]:
        return [o for o in self.device if o.cat == "kernel"]

    def ranges(self, name: str) -> List[Op]:
        return sorted((o for o in self.host if o.name == name), key=lambda o: o.start)

    def under_each(self, name: str) -> List[List[Op]]:
        """Per host range called ``name`` (in start order), the device ops
        launched inside it on its thread (a launch inside nested ranges of
        that name counts for the innermost)."""
        ranges = self.ranges(name)
        by_tid: Dict[object, List[int]] = {}
        for i, r in enumerate(ranges):
            by_tid.setdefault(r.tid, []).append(i)
        starts = {tid: [ranges[i].start for i in idx] for tid, idx in by_tid.items()}
        out: List[List[Op]] = [[] for _ in ranges]
        for o in self.device:
            idx = by_tid.get(o.tid)
            if not idx or o.launch is None:
                continue
            j = bisect.bisect_right(starts[o.tid], o.launch) - 1
            while j >= 0:
                r = ranges[idx[j]]
                if r.start <= o.launch <= r.end:
                    out[idx[j]].append(o)
                    break
                j -= 1
        return out

    def under(self, name: str) -> List[Op]:
        """Device ops launched inside a host range called ``name``."""
        return [o for ops in self.under_each(name) for o in ops]

    @property
    def busy_s(self) -> float:
        return union_s(self.device)


def union_s(ops: List[Op]) -> float:
    """Seconds covered by the union of the ops' intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for o in sorted(ops, key=lambda o: o.start):
        if cur_e is None or o.start > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = o.start, o.end
        else:
            cur_e = max(cur_e, o.end)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def parse(path: str) -> Tuple[List[Op], List[Op]]:
    """(device ops, host ranges) of a Chrome trace written by torch.profiler."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches: Dict[int, Tuple[object, float]] = {}
    device, corrs, host = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), ts)
        elif cat in DEVICE_CATS:
            device.append(Op(e.get("name", ""), ts, ts + dur, cat))
            corrs.append(e.get("args", {}).get("correlation"))
        elif cat in HOST_CATS:
            host.append(Op(e.get("name", ""), ts, ts + dur, cat, e.get("tid")))
    for o, corr in zip(device, corrs):
        o.tid, o.launch = launches.get(corr, (None, None))
    device.sort(key=lambda o: o.start)
    return device, host


def profiled(stretch: Callable[[], dict], out_dir: str, attempts: int = 5,
             agree: Callable[[bool], bool] = None) -> Window:
    """``stretch()`` (which returns the driver's counts of what it ran)
    under the profiler, retaken while the device span is off the CUDA
    events around it by more than 3%; raises after ``attempts``. With
    ``agree`` (ranks that each profile their own card), each attempt's
    verdict is the ranks' common one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace_{os.getpid()}.json")
    last = None
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            t0 = time.perf_counter()
            start.record()
            info = stretch()
            end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        device, host = parse(path)
        os.remove(path)
        timed_us = start.elapsed_time(end) * 1e3
        ok = False
        if not device:
            last = "no device activity recorded"
        else:
            span = max(o.end for o in device) - min(o.start for o in device)
            ok = abs(span / timed_us - 1) <= 0.03
            last = f"span {span:.1f} us against the events' {timed_us:.1f} us"
        if agree is not None:
            ok = agree(ok)
        if ok:
            return Window(device, host, wall, info)
        print(f"[trace] the profile's {last}: profiled again", file=sys.stderr, flush=True)
    raise RuntimeError(f"{attempts} profiles in a row disagree with the events ({last})")


def breakdown(w: Window, top: int = 10) -> dict:
    """The device ops that took most time, by name, and the longest idle
    gaps of the device by what the launching host thread was running."""
    by_name: Dict[str, float] = {}
    for o in w.device:
        by_name[o.name] = by_name.get(o.name, 0.0) + (o.end - o.start) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # Gaps of the union of device activity, named by the innermost host
    # range open on the main thread in the middle of the gap.
    gaps: Dict[str, float] = {}
    merged = []
    for o in w.device:
        if merged and o.start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], o.end)
        else:
            merged.append([o.start, o.end])
    main = _main_thread(w)
    ranges = sorted((r for r in w.host if r.tid == main), key=lambda r: (r.start, -r.end))
    stack: List[Op] = []
    nxt = 0
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        # The host ranges of one thread nest: a stack holds those open at mid.
        while nxt < len(ranges) and ranges[nxt].start <= mid:
            while stack and stack[-1].end < ranges[nxt].start:
                stack.pop()
            stack.append(ranges[nxt])
            nxt += 1
        while stack and stack[-1].end < mid:
            stack.pop()
        name = stack[-1].name if stack else "(no host range)"
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0) * 1e-6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}


def _main_thread(w: Window):
    """The host thread that launched most device ops."""
    counts: Dict[object, int] = {}
    for o in w.device:
        counts[o.tid] = counts.get(o.tid, 0) + 1
    return max(counts, key=counts.get) if counts else None
