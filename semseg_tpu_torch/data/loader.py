"""Threaded prefetching eval loader (``semseg_tpu/data/loader.py``
``EvalLoader``, the port's own copy).

Replaces the reference's forked dataloader stack with a compact thread
pool. PIL decode/resize and numpy normalization release the GIL for their
hot loops, so threads keep the device fed without fork overhead.
``EvalLoader`` is an index-ordered prefetch of ``ValDataset``/``TestDataset``
items, preserving deterministic output order. ``TrainLoader`` waits for the
training slice.
"""

from __future__ import annotations

import threading


class EvalLoader:
    """Ordered prefetching iterator over an indexable dataset."""

    def __init__(self, dataset, num_workers: int = 4, prefetch: int = 8):
        self.dataset = dataset
        self.num_workers = max(1, num_workers)
        self.prefetch = max(2, prefetch)

    def __len__(self):
        return len(self.dataset)

    def __iter__(self):
        n = len(self.dataset)
        results: dict[int, dict] = {}
        errors: list = []
        stop = threading.Event()
        lock = threading.Lock()
        cond = threading.Condition(lock)
        next_fetch = [0]

        def worker():
            try:
                while True:
                    with lock:
                        if next_fetch[0] >= n or errors or stop.is_set():
                            return
                        # Backpressure: don't run more than `prefetch` ahead
                        # of the consumer.
                        while len(results) >= self.prefetch:
                            cond.wait(timeout=0.5)
                            if next_fetch[0] >= n or errors or stop.is_set():
                                return
                        idx = next_fetch[0]
                        next_fetch[0] += 1
                    item = self.dataset[idx]
                    with lock:
                        results[idx] = item
                        cond.notify_all()
            except Exception as e:  # surface decode failures to the consumer
                with lock:
                    errors.append(e)
                    cond.notify_all()

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()

        try:
            for i in range(n):
                with lock:
                    while i not in results:
                        if errors:
                            raise RuntimeError(
                                "EvalLoader worker failed"
                            ) from errors[0]
                        cond.wait(timeout=0.5)
                    item = results.pop(i)
                    cond.notify_all()
                yield item
        finally:
            # Abandoned mid-stream (consumer exception / early exit): stop
            # the workers, which would otherwise spin in their backpressure
            # waits forever, pinning ~prefetch decoded pyramids.
            stop.set()
            with lock:
                cond.notify_all()
