"""Runs one cell of the benchmark once, on the cards of this machine.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints each number compared for ``correct`` beside its limit as the last
lines of standard error, and one JSON line last on standard output: the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics read from
a profiled stretch after the window (``--trace 1``). A cell on several
cards runs one process per card, and the first prints the result. Exits
with 2 and no result when the cell's cards are not visible, and with 3 and
no result when the run loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()  # set-up starts with the process

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h100_bench import harness  # noqa: E402


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    harness.set_cache_dirs()
    cell = harness.load_cell(args.workload)
    harness.check_device(cell.chips)
    import torch

    driver = harness.driver_module(cell.driver)
    if cell.chips > 1:  # rank 0 of the driver's ranks prints the result
        return driver.run_ranks(cell, args.seed, args.seconds, bool(args.trace), T0)
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    return harness.finish(cell, out, bool(args.trace), torch.cuda.get_device_name(0))


if __name__ == "__main__":
    sys.exit(main())
