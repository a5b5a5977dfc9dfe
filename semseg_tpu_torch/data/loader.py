"""Threaded prefetching loaders (``semseg_tpu/data/loader.py``, the port's
own copy).

Replaces the reference's forked dataloader stack with a compact thread
pool. PIL decode/resize and numpy normalization release the GIL for their
hot loops, so threads keep the device fed without fork overhead.

* ``TrainLoader`` — worker threads, each with its own seeded
  ``TrainDataset`` stream, push batches into a bounded queue; a worker's
  error is raised on the consumer.
* ``EvalLoader`` — index-ordered prefetch of ``ValDataset``/``TestDataset``
  items, preserving deterministic output order.
"""

from __future__ import annotations

import queue
import threading


class TrainLoader:
    def __init__(self, make_dataset, num_workers: int = 4, prefetch: int = 8):
        """``make_dataset(worker_id) -> TrainDataset``."""
        self.num_workers = max(1, num_workers)
        self.queue: "queue.Queue" = queue.Queue(maxsize=max(2, prefetch))
        self._stop = threading.Event()
        self._errors: list = []
        self._threads = [threading.Thread(target=self._worker, args=(make_dataset, w),
                                          daemon=True)
                         for w in range(self.num_workers)]
        for t in self._threads:
            t.start()

    def _worker(self, make_dataset, worker_id):
        try:
            ds = make_dataset(worker_id)
            while not self._stop.is_set():
                batch = ds.next_batch()
                while not self._stop.is_set():
                    try:
                        self.queue.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except Exception as e:
            self._errors.append(e)

    def __iter__(self):
        empty = queue.Empty  # bound here: module globals may be gone at shutdown
        while True:
            # Checked before blocking: a dead worker's error surfaces even
            # while the others keep the queue fed.
            if self._errors:
                raise RuntimeError("TrainLoader worker failed") from self._errors[0]
            try:
                yield self.queue.get(timeout=1.0)
            except empty:
                if not any(t.is_alive() for t in self._threads):
                    if self._errors:
                        raise RuntimeError("TrainLoader worker failed") from self._errors[0]
                    raise RuntimeError("All TrainLoader workers exited")

    def close(self):
        """Stops the workers and waits for them (each finishes its batch)."""
        self._stop.set()
        for t in self._threads:
            t.join()


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
