"""The control of ``correct`` at each one-card cell's own size: the plain
reference computed in float8 (the precision below the configuration's
bfloat16), put in the program's place, must fail one of the cell's limits,
while the program passes them all, on one seed. It runs only on the card
(``python -m pytest -m cuda h100_bench/tests``)."""

import json
import os

import pytest

from h100_bench import calibrate, harness

CELLS = [w["name"] for w in json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
         ["workloads"] if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")
    harness.set_cache_dirs()
    c = harness.load_cell(cell)
    seed = 4_000_000_007
    if c.driver == "eval_ms":
        from h100_bench.drivers import eval_ms

        engine, _ = eval_ms.build(c, seed, "cuda")
        line = calibrate.eval_seed(c, engine, seed, "cuda")
        del engine
    else:
        line = calibrate.train_seed(c, seed, "cuda")
    limits = c.traffic["limits"]
    assert all(line["program"][k] <= v for k, v in limits.items()), line["program"]
    assert any(line["control"][k] > v for k, v in limits.items()), line["control"]
