"""Process helpers (``semseg_tpu/parallel/distributed.py``), one process."""

from __future__ import annotations


def process_seed(base_seed: int, worker: int = 0) -> int:
    """De-correlated per-worker data seed; the JAX package's formula with
    process index 0 (the port trains in one process)."""
    return base_seed * 100_003 + worker
