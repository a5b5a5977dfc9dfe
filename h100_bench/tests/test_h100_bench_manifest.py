"""BENCHMARK.json and the files it names, against the benchmark's rules."""

import json
import math
import os
import re

import pytest

from h100_bench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_command(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["paths"] == ["h100_bench"]
    assert manifest["command"][1].startswith("h100_bench/")
    assert 1 <= manifest["run_seconds"] <= 51 and isinstance(manifest["run_seconds"], int)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_names_and_units(manifest):
    names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    names += [c["name"] for c in manifest["configs"] + manifest["workloads"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names)) == len(names)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_bounds(manifest):
    names = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in names
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m


def test_every_moves_is_reported_by_its_cells(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    reports = {m["name"]: set(m.get("workloads", cells)) for m in manifest["end_to_end"]}
    layers = set()
    for m in manifest["per_layer"]:
        assert m["moves"] in reports, m
        assert set(m["workloads"]) <= reports[m["moves"]], m
        layers.add(m["layer"])
    for cell in cells:
        e2e = [k for k, v in reports.items() if cell in v]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert any(cell in m["workloads"] for m in manifest["per_layer"]), cell


def test_configs_and_cells(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}
    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, math.floor(0.25 * len(manifest["workloads"])))
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in manifest["workloads"]:
        assert len(w["why"]) <= 200
        cell = harness.load_cell(w["name"])
        assert os.path.isfile(os.path.join(harness.BENCH, "drivers", cell.driver + ".py"))
        assert cell.per_layer, w["name"]


def test_every_metric_has_a_reader(manifest):
    for m in manifest["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_file_names(manifest):
    for top, _, files in os.walk(harness.BENCH):
        if "__pycache__" in top:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(top, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel) and len(rel) <= 200, rel
