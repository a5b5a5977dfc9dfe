"""Driver ``train``: the training loop of ``cli.train.train_one_epoch``.

``parallel.train_step`` fed through ``parallel.mesh.device_prefetch`` (its
thread packs each host batch into pinned memory and uploads it on a side
stream), uint8 transport normalised on the card, the loss and accuracy
fetched every ``disp_iter`` steps. The host batches are the cell's list
(``data.train_batches``: ``TrainDataset.next_batch``'s canvases, every
short side in both aspect bins), cycled in the seed's order; each step's
Dropout2d masks come from a CPU generator seeded from the seed and the step.

Set-up: the model with the seed's weights, the train state, the batches,
and one pass over the list (every canvas of the window), whose first steps
the reference follows. The window runs whole passes until ``seconds`` have
passed: ``train_img_per_s`` (images over the window's time),
``train_step_ms_p95`` (the 95th percentile of the intervals between CUDA
events recorded on the compute stream after each step, no host
synchronise per step), ``train_peak_gib`` (``max_memory_allocated`` over
the window). The traced run profiles one more pass; its shares of time
read the window's time a pass, and its FLOPs the whole window's.

``correct``: the first ``checked_steps`` steps against the plain reference
from the same weights and batches (``compare``): the first gradient as SGD
takes it, per leaf, from the momentum after step 1 (``grad_gap``, the
worst leaf; ``grad_median``, the median leaf), and each leaf's change after
the last checked step, BN's running statistics included
(``change_median``); norms compared per leaf against the larger of the
leaf's and the median leaf's reference norm.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from h100_bench import data, frozen, harness, trace
from h100_bench.drivers.eval_ms import arch_of, no_tf32, reference_dtype
from h100_bench.reference.model import forward_flops

STAT_SUFFIXES = (".running_mean", ".running_var")


def dropout_generator(seed: int, step: int):
    """The CPU generator step ``step`` draws its dropout masks from."""
    import torch

    return torch.Generator().manual_seed((seed * 1_000_003 + step) % (1 << 63))


def keep_masks(seed: int, step: int, n: int, count: int, channels: int = 512, p: float = 0.1):
    """The Dropout2d keep masks a step of the global batch ``n`` draws, in
    order (what ``models.layers.Dropout2d`` draws from the step's
    generator)."""
    import torch

    g = dropout_generator(seed, step)
    return [torch.rand(n, channels, generator=g) >= p for _ in range(count)]


def step_counts(config: dict, plan_batch: dict, flops_cache: dict, ranks: int = 1) -> dict:
    """Training FLOPs (3 x the forward's) and the pool backward's bytes of
    one step of a rank's batch."""
    arch = arch_of(config)
    h, w = plan_batch["canvas"]
    n = len(plan_batch["sizes"]) // ranks
    if (h, w) not in flops_cache:
        flops_cache[(h, w)] = forward_flops(arch, (1, 3, h, w), training=True)
    elsize = 2 if config["cfg"]["TPU"]["compute_dtype"] == "bfloat16" else 4
    os_ = arch.output_stride
    return {"flops": 3 * n * flops_cache[(h, w)],
            "pool_bwd_bytes": frozen.pool_backward_bytes((n, h // os_, w // os_, arch.fc_dim),
                                                         elsize)}


def hyper(config: dict):
    from h100_bench.reference.train import Hyper

    t = config["cfg"]["TRAIN"]
    return Hyper(t["lr_encoder"], t["lr_decoder"], t["lr_pow"], t["beta1"], t["weight_decay"],
                 t["deep_sup_scale"], t["num_epoch"] * t["epoch_iters"])


def changed_leaves(ref_grads: Dict[str, float], names) -> List[str]:
    """The leaves whose change is compared: BN's running statistics, and
    every parameter whose reference gradient is at least a thousandth of
    the median leaf's (the rest move by rounding alone)."""
    med = float(np.median(list(ref_grads.values())))
    return [k for k in names if k.endswith(STAT_SUFFIXES) or ref_grads.get(k, 0.0) >= 1e-3 * med]


class Trainer:
    """The program's train state and feed for one process (one rank)."""

    def __init__(self, cell: harness.Cell, seed: int, device: str, group=None, rank: int = 0):
        """One rank's trainer: with ``group`` (a data-parallel run) rank
        ``rank``'s, fed its slice of each global batch through the
        program's canvas exchange."""
        import functools

        import torch
        from semseg_tpu_torch.models.builder import ModelBuilder
        from semseg_tpu_torch.parallel import distributed
        from semseg_tpu_torch.parallel.mesh import device_prefetch
        from semseg_tpu_torch.parallel.train_step import create_train_state

        from h100_bench.reference.model import seeded_params

        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        cfg = harness.port_cfg(cell.config)
        model = ModelBuilder.build_model(cfg, device=self.device)
        self.params0 = seeded_params(arch_of(cell.config), seed, self.device)
        model.load_state_dict(self.params0)
        self.state = create_train_state(cfg, model, group)
        model.train()
        self.model = model
        self.host = data.train_batches(cell.traffic, cell.config, seed, self.device, rank)
        self.exchange, put = None, None
        if group is not None:
            self.exchange = distributed.CanvasExchange(f"h100_bench/{seed}")
            put = functools.partial(distributed._sync_batch_canvas, exchange=self.exchange)
        self.plan = data.train_plan(cell.traffic, cell.config)
        order = np.random.RandomState(seed % (1 << 32)).permutation(len(self.plan))
        self.plan = [self.plan[k] for k in order]

        def cycle():
            i = 0
            while True:
                yield self.host[i % len(self.host)]
                i += 1

        self.batches = device_prefetch(cycle(), self.device, depth=cell.traffic["prefetch"],
                                       put=put)
        self.pending: list = []
        self.losses: List = []
        self.waits: List[float] = []

    def step(self, record_loss: bool = False):
        import torch
        from semseg_tpu_torch.parallel.train_step import train_step

        t = time.perf_counter()
        batch = next(self.batches)
        self.waits.append(time.perf_counter() - t)
        metrics = train_step(self.state, batch, dropout_generator(self.seed, self.state.step))
        if record_loss:
            self.losses.append(metrics["loss"])
        self.pending.append(torch.stack([metrics["loss"], metrics["acc"]]))
        if len(self.pending) == self.cell.traffic["disp_iter"]:
            self.fetch()

    def fetch(self):
        """The pending losses and accuracies to the host, as
        ``train_one_epoch`` fetches them; a non-finite loss raises."""
        import torch

        if self.pending:
            values = torch.stack(self.pending).tolist()
            self.pending.clear()
            if not all(np.isfinite(loss) for loss, _ in values):
                raise FloatingPointError(f"non-finite loss by step {self.state.step}")

    def first_steps(self, checked: int, steps: int = None) -> dict:
        """``steps`` steps (default: one pass over the batches); the
        readings of the first ``checked``: their losses, each leaf's first
        gradient as SGD takes it (the momentum after step 1), each leaf's
        change after step ``checked``."""
        import torch

        steps = len(self.host) if steps is None else steps
        if not 0 < checked <= min(steps, len(self.host)):
            raise ValueError(f"{checked} checked steps in a pass of {len(self.host)}")
        readings: dict = {}
        names = dict(self.model.named_parameters())
        for i in range(steps):
            self.step(record_loss=i < checked)
            if i == 0:  # a leaf SGD has not taken reads 0
                opt = self.state.optimizer
                bufs = {k: opt.state.get(p, {}).get("momentum_buffer") for k, p in names.items()}
                readings["grad_norms"] = {k: 0.0 if b is None else float(b.double().norm())
                                          for k, b in bufs.items()}
            if i + 1 == checked:
                state = self.model.state_dict()
                with torch.no_grad():
                    readings["change_norms"] = {
                        k: float((state[k].double() - self.params0[k].double()).norm())
                        for k in list(names) + [k for k in state if k.endswith(STAT_SUFFIXES)]}
        self.fetch()
        readings["losses"] = [float(x) for x in self.losses]
        self.params0 = None
        return readings

    def close(self):
        """Stops the feed and waits for its thread (and the exchange's
        waits) to end."""
        import threading

        self.batches.close()
        if self.exchange is not None:
            self.exchange.close()
        for t in threading.enumerate():
            if t is not threading.main_thread() and t.daemon:
                t.join(timeout=10)


def reference_readings(cell: harness.Cell, seed: int, host: List[dict], checked: int,
                       device: str, low: str = None):
    """The plain reference's readings over the first ``checked`` batches of
    ``host`` (global batches), from the seed's weights; with ``low`` its
    storage in that precision (``reference.model.Numerics``)."""
    import torch

    from h100_bench.reference.model import Numerics, seeded_params
    from h100_bench.reference.train import follow

    arch = arch_of(cell.config)
    dev = torch.device(device)
    count = 2 if cell.config["cfg"]["MODEL"]["arch_decoder"].endswith("deepsup") else 0
    with no_tf32():
        return follow(seeded_params(arch, seed, dev), arch, hyper(cell.config), host[:checked],
                      lambda step, n: keep_masks(seed, step, n, count),
                      Numerics(reference_dtype(cell.config), low), remat=True)


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's gap of norms, over the larger of its reference norm and
    the median leaf's."""
    med = float(np.median(list(reference.values())))
    return {k: abs(program[k] - r) / max(r, med, 1e-30) for k, r in reference.items()}


def median_gap(gaps: Dict[str, float]) -> float:
    return float(np.median(list(gaps.values())))


def compare(program: dict, ref, detail: bool = False) -> Dict[str, float]:
    """The readings of ``correct``: the checked steps' worst loss gap
    (``loss_gap``, read but not compared: PERF.md); the worst leaf's gap
    of first-gradient norms (``grad_gap``) and the median leaf's
    (``grad_median``, steady from seed to seed); the median leaf's gap of
    change norms after the checked steps (``change_median``, which stands
    in for the worst leaf's, a reading of the later steps' chaos). With
    ``detail`` also the worst leaves."""
    loss = [abs(p - r) / abs(r) for p, r in zip(program["losses"], ref.losses)]
    grad = leaf_gaps(program["grad_norms"], ref.grad_norms)
    keep = changed_leaves(ref.grad_norms, ref.change_norms)
    change = leaf_gaps({k: program["change_norms"][k] for k in keep},
                       {k: ref.change_norms[k] for k in keep})
    out = {"loss_gap": max(loss), "grad_gap": max(grad.values()),
           "grad_median": median_gap(grad), "change_median": median_gap(change)}
    if detail:
        out.update(
            loss_gaps=loss, change_gap=max(change.values()),
            grad_worst=sorted(grad.items(), key=lambda kv: -kv[1])[:3],
            change_worst=sorted(change.items(), key=lambda kv: -kv[1])[:3],
            left_out=sorted(set(ref.change_norms) - set(keep)))
    return out


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
        t0: float = None, group=None, rank: int = 0) -> dict:
    """One run of the cell in this process; with ``group``, as rank
    ``rank`` of a data-parallel run (the metrics are the ranks' together,
    and only rank 0 checks ``correct``)."""
    import torch
    import torch.distributed as dist

    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter() if t0 is None else t0
    tr = cell.traffic
    world = 1 if group is None else dist.get_world_size(group)
    phases = {"start": time.perf_counter() - t0}
    trainer = Trainer(cell, seed, device, group, rank)
    if on_card:
        torch.cuda.synchronize()
    phases["model, state, data"] = time.perf_counter() - t0 - sum(phases.values())
    readings = trainer.first_steps(tr["checked_steps"])
    if on_card:
        torch.cuda.synchronize()
    phases["first pass"] = time.perf_counter() - t0 - sum(phases.values())
    setup_s = time.perf_counter() - t0

    def reduce(value: float, op) -> float:
        """``value`` combined over the ranks."""
        if group is None:
            return value
        t = torch.tensor([value], dtype=torch.float64, device=device)
        dist.all_reduce(t, op=op, group=group)
        return float(t)

    n_batches = len(trainer.host)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        first = torch.cuda.Event(enable_timing=True)
        first.record()
    events, steps, pass_ends = [], 0, []
    trainer.waits.clear()
    start = time.perf_counter()
    while True:
        trainer.step()
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        steps += 1
        if steps % n_batches == 0:
            pass_ends.append(time.perf_counter() - start)
            # Every rank stops after the same pass, once a rank's clock is past.
            if reduce(float(pass_ends[-1] >= seconds), dist.ReduceOp.MAX):
                break
    trainer.fetch()
    if on_card:
        torch.cuda.synchronize()
    elapsed = reduce(time.perf_counter() - start, dist.ReduceOp.MAX)
    passes = steps // n_batches
    passes_s = [b - a for a, b in zip([0.0] + pass_ends, pass_ends)]
    notes = [f"window: {passes} passes in {elapsed!r} s; each pass (host clock): "
             f"{', '.join(f'{t:.4f}' for t in passes_s)} s"]
    metrics = {"train_img_per_s": steps * tr["batch_per_gpu"] * world / elapsed,
               "setup_s": reduce(setup_s, dist.ReduceOp.MAX)}
    peak = 0
    if on_card:
        marks = [first] + events
        intervals = sorted(a.elapsed_time(b) for a, b in zip(marks, marks[1:]))
        metrics["train_step_ms_p95"] = float(np.percentile(intervals, 95))
        peak = int(reduce(torch.cuda.max_memory_allocated(), dist.ReduceOp.MAX))
        metrics["train_peak_gib"] = peak / 2**30

    window, busy_s = None, None
    if traced and on_card:
        flops_cache: dict = {}
        counts = [step_counts(cell.config, b, flops_cache, world) for b in trainer.plan]
        pass_flops = world * sum(c["flops"] for c in counts)

        def stretch():
            trainer.waits.clear()
            for _ in range(n_batches):
                trainer.step()
            trainer.fetch()
            return {"kind": "train", "steps": n_batches, "chips": world,
                    "pool_bwd_bytes": sum(c["pool_bwd_bytes"] for c in counts),
                    "data_wait_s": list(trainer.waits), "paced_s": elapsed / passes,
                    "window_flops": pass_flops * passes, "window_s": elapsed}

        # The window ended on a whole pass, so the stretch runs the list
        # from its first batch, in the order of ``counts``.
        agree = None if group is None else (lambda ok: bool(reduce(float(ok), dist.ReduceOp.MIN)))
        window = trace.profiled(stretch, harness.CACHE, agree=agree)
        busy_s = reduce(window.busy_s, dist.ReduceOp.SUM) / world
        notes.append(f"traced pass: {window.traced_s!r} s, the card busy {window.busy_s!r} s; "
                     f"a pass of the untraced window: {elapsed / passes!r} s")

    trainer.close()
    del trainer
    if on_card:
        torch.cuda.empty_cache()
    out = {"attempted": steps, "failed": 0, "metrics": metrics, "memory_peak_bytes": peak,
           "window": window, "busy_s": busy_s, "checks": [], "readings": {}, "phases": phases,
           "notes": notes}
    if rank == 0:  # the reference follows the global batches
        host = data.train_batches(tr, cell.config, seed, torch.device(device))
        ref = reference_readings(cell, seed, host, tr["checked_steps"], device)
        out["readings"] = compare(readings, ref)
        limits = tr["limits"]
        out["checks"] = [harness.Check(k, out["readings"][k], v) for k, v in limits.items()]
    if busy_s is None:
        del out["busy_s"]
    return out


def _rank_main(cell: harness.Cell, seed: int, seconds: float, traced: bool, port: int,
               start_wall: float, rank: int, device: str) -> None:
    """One rank of ``run_ranks``: joins the process group (NCCL on card
    ``rank``, gloo on the CPU) and runs the cell; rank 0 prints the
    result."""
    import sys

    import torch
    import torch.distributed as dist
    from semseg_tpu_torch.parallel import distributed

    harness.set_cache_dirs()
    if device == "cpu":
        torch.set_num_threads(1)
    t0 = time.perf_counter() - (time.time() - start_wall)
    dev = distributed.initialize(f"127.0.0.1:{port}", cell.chips, rank, device=device)
    code = 0
    try:
        out = run(cell, seed, seconds, traced, str(dev), t0, dist.group.WORLD, rank)
        if rank == 0:
            kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
            code = harness.finish(cell, out, traced, kind)
    finally:
        distributed.shutdown()
    sys.exit(code)


def run_ranks(cell: harness.Cell, seed: int, seconds: float, traced: bool, t0: float,
              device: str = "cuda") -> int:
    """The cell over ``cell.chips`` cards, one process (rank) per card
    (``device`` cpu: gloo ranks on the CPU, for tests); rank 0 prints the
    result. Returns the exit code: rank 0's, or 1 when any rank failed
    (the others are then ended)."""
    import multiprocessing as mp

    from semseg_tpu_torch.parallel import distributed

    port = distributed.free_port()
    start_wall = time.time() - (time.perf_counter() - t0)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(cell, seed, seconds, traced, port,
                                                   start_wall, r, device))
             for r in range(cell.chips)]
    for p in procs:
        p.start()
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join()
    codes = [p.exitcode for p in procs]
    return codes[0] if all(c == 0 for c in codes[1:]) else 1
