"""Each driver at a tiny size on the CPU through its test-only entry
(``run(..., device="cpu")``), and ``run.py`` itself, which refuses to run
without the cell's cards."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from h100_bench import harness
from h100_bench.tests import tiny

CELLS = [w["name"] for w in json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
         ["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_driver_runs_at_a_tiny_size(cell):
    c = tiny.tiny(cell)
    out = harness.driver_module(c.driver).run(c, 2**31 + 9, 0.0, False, "cpu")
    reported = {m["name"] for m in c.end_to_end}
    # The CPU has no CUDA events or allocator statistics: only the host's metrics.
    assert {"setup_s"} <= set(out["metrics"]) <= reported
    assert out["attempted"] > 0 and out["checks"]
    assert all(isinstance(ch.value, float) for ch in out["checks"])


def test_train_driver_runs_four_ranks(capfd):
    """The training driver as four data-parallel ranks (one process each,
    gloo on the CPU), as ``workloads/r50d-ppm.train-ddp4.json`` runs it on
    four cards; rank 0 prints the result line."""
    from h100_bench.drivers import train

    c = tiny.tiny("r50d-ppm.train-b8")
    c.chips, c.traffic["ranks"], c.traffic["batch_per_gpu"] = 4, 4, 1
    # The CPU has no CUDA events or allocator statistics: only the host's metrics.
    c.end_to_end = [m for m in c.end_to_end if m["name"] in ("setup_s", "train_img_per_s")]
    assert train.run_ranks(c, 2**31 + 9, 0.0, False, 0.0, "cpu") == 0
    out = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
    assert set(c.traffic["limits"]) <= set(out["checks"]) and out["attempted"] > 0
    assert set(out["metrics"]) == {"setup_s", "train_img_per_s"}


def _run(args, cwd):
    return subprocess.run([sys.executable, "h100_bench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_run_refuses_without_a_card():
    done = _run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                harness.ROOT)
    assert done.returncode == 2 and done.stdout == ""
    assert "CUDA card" in done.stderr


def test_run_refuses_an_unknown_cell():
    done = _run(["--workload", "no-such-cell", "--seed", "1", "--seconds", "1"], harness.ROOT)
    assert done.returncode != 0 and done.stdout == ""


def test_run_without_the_program_fails(tmp_path):
    """A checkout of only the benchmark cannot load the program's modules."""
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.');"
            "from h100_bench import harness;"
            "harness.port_cfg(harness.load_cell(sys.argv[1]).config)")
    done = subprocess.run([sys.executable, "-c", code, CELLS[0]], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode != 0 and "semseg_tpu_torch" in done.stderr


def test_result_line_keys_and_checks_last(capsys):
    result = {"correct": True, "attempted": 3, "failed": 0,
              "metrics": {"setup_s": {"value": 1.5, "unit": "s"}},
              "device": {"platform": "gpu", "kind": "card", "count": 1,
                         "memory_peak_bytes": 1}}
    assert harness.emit(result, [harness.Check("count_gap", 0.5, 0.25)]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["correct"] is False
    assert line["checks"]["count_gap"] == {"value": 0.5, "limit": 0.25}
    assert err.strip().splitlines()[-1].startswith("check count_gap: 0.5 limit 0.25")
