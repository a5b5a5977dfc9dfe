"""Readings that set the limits of ``correct``, made on the card at each
cell's own size; the benchmark's runs do not make them.

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1,2,3 [--out FILE]

For each seed, in one process: the program's readings as a run makes them
(eval: one call of each chunk, the seed's checked images; training: the
first checked steps) against the plain reference; the control, the
reference computed with every convolution in float8 (the precision below
the configuration's bfloat16), put in the program's place against the same
reference; and for training the fault of half of each batch left out (the
mean over the rest), for a data-parallel cell the exchange between cards
left out (the first rank's slice trained alone). Prints one JSON line per
seed and writes them all to ``--out``.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h100_bench import harness  # noqa: E402


def eval_seed(cell, engine, seed: int, device: str) -> dict:
    """One seed's eval readings: the program's answers for the checked
    images (one call of each chunk), the control's (the reference storing
    in float8) and, as a witness, the reference storing in bfloat16, each
    against the float32 reference."""
    import torch

    from h100_bench import data
    from h100_bench.drivers import eval_ms

    engine.model.load_state_dict(eval_ms.weights(cell, seed, device))
    chunks = data.eval_chunks(cell.traffic, seed, cell.config["cfg"]["DATASET"]["num_class"],
                              torch.device(device))
    chosen = eval_ms.checked(seed, cell.traffic)
    eval_ms.label_checked(cell, seed, chunks, chosen, device)
    answers = [engine.batched_metrics_from_originals(*c) for c in chunks]
    prog = [eval_ms.answer(answers[k][i]) for k, i in chosen]
    ref = eval_ms.reference_counts(cell, seed, chunks, chosen, device)
    out = {}
    for who, counts in (("program", prog),
                        ("bfloat16", eval_ms.reference_counts(cell, seed, chunks, chosen,
                                                              device, "bfloat16")),
                        ("control", eval_ms.reference_counts(cell, seed, chunks, chosen,
                                                             device, "float8"))):
        g = [eval_ms.gaps(c, r) for c, r in zip(counts, ref)]
        out[who] = {"count_gap": max(x for x, _ in g), "pix_gap": max(y for _, y in g),
                    "count_gaps": [x for x, _ in g]}
    return out


def followed(f) -> dict:
    """A reference's readings in the form of the program's."""
    return {"losses": f.losses, "grad_norms": f.grad_norms, "change_norms": f.change_norms}


def train_seed(cell, seed: int, device: str, witness: bool = False, study: bool = False) -> dict:
    """Program, control and half-batch readings of one seed; with
    ``witness`` also the program computing in float32 (TF32 off), a
    second witness of what the program's bfloat16 reads; with ``study``
    the program after each earlier step and the reference in bfloat16
    (against float32) and in float32 (against float64)."""
    import copy

    import torch

    from h100_bench.drivers import eval_ms, train

    checked = cell.traffic["checked_steps"]

    def program(c=cell, k=checked):
        trainer = train.Trainer(c, seed, device)
        readings = trainer.first_steps(k, steps=k)
        trainer.close()
        host = trainer.host
        del trainer
        torch.cuda.empty_cache()
        return readings, host

    prog, host = program()
    with half_of_each_batch():
        fault, _ = program()
    ref = train.reference_readings(cell, seed, host, checked, device)
    ctl = train.reference_readings(cell, seed, host, checked, device, "float8")
    out = {"program": train.compare(prog, ref, detail=True),
           "control": train.compare(followed(ctl), ref, detail=True),
           "half_batch": train.compare(fault, ref, detail=True)}
    if witness:
        f32 = copy.deepcopy(cell)
        f32.config["cfg"]["TPU"]["compute_dtype"] = "float32"
        with eval_ms.no_tf32():
            prog32, _ = program(f32)
        out["program_f32"] = train.compare(prog32, ref, detail=True)
    if study:
        # Where the worst leaf's change comes from: the program after 1 and
        # 2 steps; the reference itself in the configuration's bfloat16 and
        # in float32 against float64, all at the cell's size.
        for k in range(1, checked):
            early, _ = program(k=k)
            out[f"program_{k}"] = train.compare(
                early, train.reference_readings(cell, seed, host, k, device), detail=True)
        low = train.reference_readings(cell, seed, host, checked, device, "bfloat16")
        out["reference_bf16"] = train.compare(followed(low), ref, detail=True)
        f64 = copy.deepcopy(cell)
        f64.config["cfg"]["TPU"]["compute_dtype"] = "float64"
        ref64 = train.reference_readings(f64, seed, host, checked, device)
        out["reference_f32_f64"] = train.compare(followed(ref), ref64, detail=True)
    return out


class half_of_each_batch:
    """The fault of half of each batch left out: each step of the program
    on the first half of its batch, the mean over it alone."""

    def __enter__(self):
        import importlib

        # The package's ``train_step`` attribute is the function; the
        # module the driver imports it from is this one.
        ts = importlib.import_module("semseg_tpu_torch.parallel.train_step")
        self.module, self.step = ts, ts.train_step

        def half(state, batch, *a, **kw):
            n = batch["img_data"].shape[0] // 2
            return self.step(state, {k: v[:n] for k, v in batch.items()}, *a, **kw)

        ts.train_step = half

    def __exit__(self, *exc):
        self.module.train_step = self.step


def _rank(cell, seeds, port: int, rank: int, out: str, faults: int) -> None:
    """One rank of a data-parallel cell's readings: every rank runs the
    program's first steps of each seed; rank 0 then adds the fault of the
    exchange between cards left out (its slice trained alone), and for the
    first ``faults`` seeds the control, and writes the lines to ``out``."""
    import torch
    import torch.distributed as dist
    from semseg_tpu_torch.parallel import distributed

    from h100_bench import data
    from h100_bench.drivers import train

    harness.set_cache_dirs()
    dev = distributed.initialize(f"127.0.0.1:{port}", cell.chips, rank, device="cuda")
    checked = cell.traffic["checked_steps"]

    def first_steps(group):
        trainer = train.Trainer(cell, seed, str(dev), group, rank)
        readings = trainer.first_steps(checked, steps=checked)
        trainer.close()
        del trainer
        torch.cuda.empty_cache()
        return readings

    lines = []
    try:
        for n, seed in enumerate(seeds):
            t = time.perf_counter()
            prog = first_steps(dist.group.WORLD)
            if rank == 0:
                alone = first_steps(None)
                host = data.train_batches(cell.traffic, cell.config, seed, dev)
                ref = train.reference_readings(cell, seed, host, checked, str(dev))
                line = {"program": train.compare(prog, ref, detail=True),
                        "no_exchange": train.compare(alone, ref, detail=True)}
                if n < faults:
                    ctl = train.reference_readings(cell, seed, host, checked, str(dev), "float8")
                    line["control"] = train.compare(followed(ctl), ref, detail=True)
                line.update(cell=cell.name, seed=seed, seconds=time.perf_counter() - t,
                            kind=torch.cuda.get_device_name(dev))
                print(json.dumps(line), flush=True)
                lines.append(line)
            dist.barrier()
    finally:
        distributed.shutdown()
    if rank == 0 and out:
        with open(out, "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines) + "\n")


def ranks(cell, seeds, out: str, faults: int = 3) -> int:
    import multiprocessing as mp

    from semseg_tpu_torch.parallel import distributed

    port = distributed.free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(cell, seeds, port, r, out, faults))
             for r in range(cell.chips)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    return max(abs(p.exitcode or 0) for p in procs)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--out", default="")
    parser.add_argument("--study", action="store_true",
                        help="training: also the readings that locate the worst leaf's change")
    args = parser.parse_args(argv)
    harness.set_cache_dirs()
    cell = harness.load_cell(args.workload)
    harness.check_device(cell.chips)
    import torch

    seeds = [int(s) for s in args.seeds.split(",")]
    if cell.chips > 1:
        return ranks(cell, seeds, args.out)
    lines = []
    engine = None
    if cell.driver == "eval_ms":
        from h100_bench.drivers import eval_ms

        engine, _ = eval_ms.build(cell, seeds[0], "cuda")
    for n, seed in enumerate(seeds):
        t = time.perf_counter()
        if cell.driver == "eval_ms":
            line = eval_seed(cell, engine, seed, "cuda")
        else:
            line = train_seed(cell, seed, "cuda", witness=n < 3 or args.study,
                              study=args.study)
        line.update(cell=cell.name, seed=seed, seconds=time.perf_counter() - t,
                    kind=torch.cuda.get_device_name(0))
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
