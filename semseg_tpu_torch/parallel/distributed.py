"""Processes and ranks (``semseg_tpu/parallel/distributed.py``).

The JAX package runs one process per host, every chip in one global mesh,
and GSPMD inserts the collectives. The port runs one process (rank) per
card, ``torch.distributed`` between them: NCCL between cards, gloo on the
CPU. Each rank feeds its own slice of the global batch:

    from semseg_tpu_torch.parallel import distributed
    device = distributed.initialize()   # SEMSEG_* or torchrun's variables

* ``initialize`` is the handshake. Explicit arguments, or the
  ``SEMSEG_COORDINATOR`` / ``SEMSEG_NUM_PROCESSES`` / ``SEMSEG_PROCESS_ID``
  variables, or torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
  ``WORLD_SIZE`` (with ``LOCAL_RANK`` naming the card) make it mandatory:
  any failure raises. With none of them it logs a warning and the run stays
  one process, as the JAX package does when auto-detection fails.
* ``process_seed`` de-correlates the ranks' ``TrainDataset`` streams;
  ``global_batch_size`` and ``local_batch_slice`` place a rank's slice in
  the global batch: rank r holds rows [r*N, (r+1)*N).
* ``group_devices`` names a rank's devices under ``TPU.spatial`` (the JAX
  trainer's hybrid data x spatial mesh, ``make_mesh_2d``): each rank is one
  data group and drives its group's cards, one band of each image's
  height on each (``parallel/spatial.py``).
* ``_sync_batch_canvas`` pads each rank's batch to the cross-rank maximum
  (H, W). Shapes alone would not need it, but the padded region enters the
  batch-norm statistics in JAX, whose global batch has one canvas; without
  it the port would compute another step. The dims go through the
  handshake's store (``CanvasExchange``), not a collective, so the
  prefetch thread may run it: a collective launched from a second thread
  can deadlock against the step's own, which must reach every rank in one
  order.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
import threading
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("Logger")

# The handshake's key-value store, kept for the canvas exchange; like the
# process group it belongs to the process.
_store = None

_DEFAULT_TIMEOUT_S = 1800


def visible_cards(requested: int) -> int:
    """The first ``min(requested, visible)`` cards are the ones used, as the
    JAX package's ``make_mesh`` takes its devices; none visible raises."""
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA card is visible; pass --device cpu to run on the CPU")
    return min(requested, count)


def group_devices(device, rank: int, spatial: int) -> List[torch.device]:
    """The devices of data group ``rank``'s ``spatial`` bands: with a bare
    ``cuda`` cards ``[rank * spatial, (rank + 1) * spatial)`` of this host
    (JAX's ``make_mesh_2d`` rows); with ``cuda:K`` or ``cpu`` that one
    device for every band, as ``cli.eval --spatial`` places its bands."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        first = rank * spatial
        if visible_cards(first + spatial) < first + spatial:
            raise ValueError(f"data group {rank} of {spatial} bands needs cards {first}-"
                             f"{first + spatial - 1}; {torch.cuda.device_count()} visible")
        return [torch.device("cuda", first + j) for j in range(spatial)]
    return [d] * spatial


def _rank_device(device, local_rank: int) -> torch.device:
    """The card a rank owns: ``cuda:<local_rank>`` for a bare ``cuda``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        visible_cards(1)  # raises when none is visible
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return device


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, backend: Optional[str] = None,
               device="cuda", timeout: Optional[float] = None) -> torch.device:
    """The ``torch.distributed`` handshake; returns this rank's device.

    ``coordinator_address`` is ``host:port`` of rank 0, which serves the
    store there. ``device`` ``cuda`` gives each rank the card of its local
    rank (``LOCAL_RANK``, else ``process_id`` modulo the visible cards),
    which becomes the current device; ``cpu`` keeps the ranks on the CPU. The
    backend is NCCL when the ranks own cards and gloo on the CPU unless
    ``backend`` names one (gloo lets two ranks share one card, which NCCL
    refuses). ``timeout`` (seconds, default 1800) bounds the handshake and
    every collective.
    """
    global _store
    local_rank = int(os.environ.get("LOCAL_RANK", -1))
    if dist.is_initialized():
        return _rank_device(device, dist.get_rank() if local_rank < 0 else local_rank)

    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("SEMSEG_COORDINATOR")
        if coordinator_address is None and "MASTER_ADDR" in env:
            coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '')}"
    if num_processes is None:
        value = env.get("SEMSEG_NUM_PROCESSES", env.get("WORLD_SIZE"))
        num_processes = None if value is None else int(value)
    if process_id is None:
        value = env.get("SEMSEG_PROCESS_ID", env.get("RANK"))
        process_id = None if value is None else int(value)

    if coordinator_address is None and num_processes is None:
        logger.warning(
            "torch.distributed: no coordinator given; continuing SINGLE-PROCESS. For "
            "several processes pass coordinator_address/num_processes/process_id (or "
            "SEMSEG_COORDINATOR/SEMSEG_NUM_PROCESSES/SEMSEG_PROCESS_ID, or torchrun's "
            "MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE).")
        return _rank_device(device, max(local_rank, 0))
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "torch.distributed handshake needs a coordinator address, the number of "
            f"processes and this process's id; got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}")
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address {coordinator_address!r} is not host:port")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside [0, {num_processes})")

    rank_device = _rank_device(device, process_id if local_rank < 0 else local_rank)
    if backend is None:
        backend = "nccl" if rank_device.type == "cuda" else "gloo"
    if rank_device.type == "cuda":
        torch.cuda.set_device(rank_device)
    wait = datetime.timedelta(seconds=timeout or _DEFAULT_TIMEOUT_S)
    # Rank 0 serves the store and waits for every rank to connect; the
    # others connect to it. Either raises when the wait runs out.
    store, rank, world = next(dist.rendezvous(
        f"tcp://{host}:{port}?rank={process_id}&world_size={num_processes}", timeout=wait))
    dist.init_process_group(backend, store=store, rank=rank, world_size=world, timeout=wait)
    if dist.get_world_size() != num_processes:
        raise RuntimeError(f"torch.distributed came up with {dist.get_world_size()} "
                           f"processes, expected {num_processes}")
    _store = store
    logger.info(f"torch.distributed initialized: process {rank}/{world}, backend "
                f"{dist.get_backend()}, device {rank_device}")
    return rank_device


def free_port() -> int:
    """A TCP port free on this host now, for a coordinator on 127.0.0.1."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def shutdown() -> None:
    """Ends the process group that ``initialize`` began."""
    global _store
    if dist.is_initialized():
        dist.destroy_process_group()
    _store = None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that logs and writes checkpoints."""
    return process_index() == 0


def barrier() -> None:
    """Every rank waits for the others (a no-op in one process)."""
    if dist.is_initialized():
        dist.barrier()


def process_seed(base_seed: int, worker: int = 0) -> int:
    """De-correlated per-rank, per-worker data seed (the JAX package's formula)."""
    return base_seed * 100_003 + process_index() * 1_009 + worker


def global_batch_size(per_device: int) -> int:
    return per_device * process_count()


def local_batch_slice(per_device: int) -> slice:
    """The rows of the global batch this rank holds (one card per rank)."""
    start = process_index() * per_device
    return slice(start, start + per_device)


# Pad value per train-batch key: image padding is zeros, label padding is
# ignore (-1), as TrainDataset pads within a batch, so the loss masks it.
_PAD_VALUE = {"img_data": 0.0, "seg_label": -1}

# A peer may be slow to reach an exchange (a long first step, a checkpoint
# write), so wait up to 30 minutes, with a warning per 2 minutes.
_KV_SLICE_S = 120.0
_KV_TOTAL_S = 1800.0


def _kv_get_patient(store, key: str, closed: Optional[threading.Event] = None) -> str:
    """``store[key]`` once a peer has posted it. Polls with ``check``, which
    holds the store client only for a moment: a blocking wait would hold it
    while the main thread may need the store (NCCL's first collective sets
    up through it), and the peer's post can hang on that main thread."""
    start = time.monotonic()
    warn_at, pause = _KV_SLICE_S, 0.001
    while not store.check([key]):
        if closed is not None and closed.is_set():
            raise RuntimeError(f"canvas exchange closed while waiting on {key!r}")
        waited = time.monotonic() - start
        if waited >= _KV_TOTAL_S:
            raise TimeoutError(f"peer never posted {key!r} within {waited:.0f} s: a process "
                               "is down or wedged")
        if waited >= warn_at:
            logger.warning(f"canvas exchange: still waiting on {key} after {waited:.0f} s "
                           f"(will wait up to {_KV_TOTAL_S:.0f} s)")
            warn_at += _KV_SLICE_S
        time.sleep(pause)
        pause = min(2 * pause, 0.02)
    return store.get(key).decode()


class CanvasExchange:
    """The cross-rank elementwise max of a small int vector per call,
    through the handshake's store: no collective, so any thread may call
    it. Every rank calls it in the same sequence with the same ``tag`` (an
    epoch's stream); a rank's key of call ``i`` is removed at call
    ``i + 2``, when every peer has read it. ``close()`` ends a wait that no
    peer will answer (a stream abandoned mid-epoch)."""

    def __init__(self, tag, store=None):
        self.tag = tag
        self.seq = 0
        self.store = store if store is not None else _store
        self.closed = threading.Event()
        if self.store is None:
            raise RuntimeError("the canvas exchange needs the store of distributed.initialize()")

    def _key(self, seq, rank):
        return f"semseg/canvas_dims/{self.tag}/{seq}/{rank}"

    def __call__(self, dims: np.ndarray) -> np.ndarray:
        rank, world = process_index(), process_count()
        seq, self.seq = self.seq, self.seq + 1
        if seq >= 2:
            self.store.delete_key(self._key(seq - 2, rank))
        self.store.set(self._key(seq, rank), ",".join(map(str, np.asarray(dims).tolist())))
        rows = [np.fromiter((int(v) for v in
                             _kv_get_patient(self.store, self._key(seq, p), self.closed).split(",")),
                            np.int64) for p in range(world)]
        return np.stack(rows).max(axis=0)

    def close(self):
        self.closed.set()


def _sync_batch_canvas(local_batch: dict, exchange, microbatched: bool = False) -> dict:
    """Pad each rank's host batch to the cross-rank maximum (H, W) of every
    spatial array (``img_data`` with 0, ``seg_label`` with -1); per-image
    metadata such as ``img_valid_hw`` passes as it is. ``microbatched``: the
    arrays carry a leading grad-accum axis (K, N, H, W, ...)."""
    lead = 2 if microbatched else 1
    keys = sorted(k for k, v in local_batch.items() if v.ndim >= lead + 2)
    dims = np.asarray([d for k in keys for d in local_batch[k].shape[lead:lead + 2]], np.int64)
    global_dims = exchange(dims)

    out = dict(local_batch)
    for i, k in enumerate(keys):
        x = np.asarray(local_batch[k])
        gh, gw = int(global_dims[2 * i]), int(global_dims[2 * i + 1])
        if (gh, gw) != x.shape[lead:lead + 2]:
            pad = [(0, 0)] * lead + [(0, gh - x.shape[lead]), (0, gw - x.shape[lead + 1])]
            pad += [(0, 0)] * (x.ndim - lead - 2)
            x = np.pad(x, pad, constant_values=_PAD_VALUE.get(k, 0))
        out[k] = x
    return out
