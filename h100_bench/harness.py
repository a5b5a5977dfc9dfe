"""What every cell's run shares: finding the cell by name, the build and
kernel caches, the device check, the reading of the per-layer metrics and
the result line.

The cell's files are found by name: ``BENCHMARK.json`` at the checkout's
root lists the cells and metrics; ``h100_bench/workloads/<cell>.json`` holds
a cell's driver, configuration and traffic; ``h100_bench/configs/<config>
.json`` a configuration; ``h100_bench/drivers/<driver>.py`` a traffic
driver; ``h100_bench/metrics/<metric>.py`` a per-layer metric's reader.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(ROOT, "build", "h100_bench")
FORBIDDEN = ("jax", "jaxlib", "flax", "semseg_tpu")


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed directory of the checkout;
    no library of the run loads JAX."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(names=None) -> List[str]:
    """Top-level names of loaded modules (or of ``names``) that a run may
    not load, compared whole (``semseg_tpu_torch`` is not ``semseg_tpu``)."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    driver: str
    config: dict
    traffic: dict
    per_layer: List[dict] = field(default_factory=list)
    end_to_end: List[dict] = field(default_factory=list)


def load_cell(name: str, root: str = ROOT) -> Cell:
    manifest = _json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    spec = _json(os.path.join(BENCH, "workloads", name + ".json"))
    if spec["config"] != entry["config"] or spec["chips"] != entry["chips"]:
        raise SystemExit(f"workloads/{name}.json disagrees with BENCHMARK.json")
    config = _json(os.path.join(BENCH, "configs", entry["config"] + ".json"))

    def mine(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in manifest["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"] if mine(m) and m["moves"] in names]
    return Cell(name, entry["chips"], spec["driver"], config, spec["traffic"], layer, e2e)


def port_cfg(config: dict):
    """The program's config node with the configuration's settings."""
    from semseg_tpu_torch.config import cfg as defaults

    cfg = defaults.clone()
    flat = []
    for section, values in config["cfg"].items():
        for key, value in values.items():
            flat += [f"{section}.{key}", value]
    cfg.merge_from_list(flat)
    return cfg


def check_device(chips: int) -> None:
    """Exits with 2, printing no result, unless ``chips`` cards are visible."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"h100_bench: the cell needs {chips} CUDA card(s); {count} visible",
              file=sys.stderr)
        raise SystemExit(2)


def driver_module(name: str):
    return importlib.import_module(f"h100_bench.drivers.{name}")


def metric_reader(name: str):
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"h100_bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_per_layer(cell: Cell, window) -> Dict[str, dict]:
    """Each of the cell's per-layer metrics that its reader finds in the
    traced ``window``; a reader that finds nothing returns None and the
    metric is left out."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"])(window)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


@dataclass
class Check:
    """One number compared for ``correct``, with its limit (the number
    must not exceed it)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def result_line(cell: Cell, out: dict, traced: bool, kind: str) -> dict:
    """The result's keys from a driver's outcome: its end-to-end metrics,
    or with ``traced`` its per-layer metrics, the device and the
    breakdown of the traced window."""
    from h100_bench import trace

    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    if traced:
        window = out["window"]
        metrics = read_per_layer(cell, window)
    else:
        missing = set(units) - set(out["metrics"])
        if missing:
            raise RuntimeError(f"the driver measured no {sorted(missing)}")
        metrics = {k: {"value": out["metrics"][k], "unit": units[k]} for k in units}
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": True, "attempted": int(out["attempted"]), "failed": int(out["failed"]),
              "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = out.get("busy_s", window.busy_s)
        device["window_s"] = window.traced_s
        result["breakdown"] = trace.breakdown(window)
    return result


def finish(cell: Cell, out: dict, traced: bool, kind: str) -> int:
    """Prints the set-up's phases, the driver's notes (the window's times)
    and the result of a driver's outcome; returns the exit code."""
    phases = ", ".join(f"{k} {v:.3f} s" for k, v in out.get("phases", {}).items())
    print(f"set-up: {phases}", file=sys.stderr)
    for note in out.get("notes", []):
        print(note, file=sys.stderr)
    return emit(result_line(cell, out, traced, kind), out["checks"])


def emit(result: dict, checks: List[Check]) -> int:
    """Prints the checks on standard error and the result line last on
    standard output; returns the exit code (0 unless a forbidden module
    was loaded, when nothing is printed to standard output)."""
    bad = forbidden_modules()
    if bad:
        print(f"h100_bench: the run loaded {bad}", file=sys.stderr)
        return 3
    result = dict(result)
    result["correct"] = bool(result.get("correct", True)) and all(c.ok for c in checks)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    for c in checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
