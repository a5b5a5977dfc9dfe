"""Host → device batch prefetch (``semseg_tpu/parallel/mesh.py``
``device_prefetch``) onto one rank's card.

A thread packs each host batch into one pinned buffer and uploads it on a
side stream, ``depth`` batches ahead of the step. ``put`` (JAX's hook)
transforms each host batch on that thread first: a data-parallel rank pads
it to the cross-rank canvas there (``distributed._sync_batch_canvas``,
which launches no collective). The consumer's stream
waits on each batch's event before using it, and the batch's memory is
marked as used there, as the eval engines' uploader does
(``upload.Upload``). Abandoning the generator (an error in the step loop,
an early exit) stops the thread and drains the queue, so no uploaded
batches stay pinned on the card.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from semseg_tpu_torch.upload import Upload


def device_prefetch(iterator, device, depth: int = 2, put=None):
    """Yields the host batches (dicts of numpy arrays) of ``iterator``,
    passed through ``put`` (host batch → host batch) when given, as dicts of
    tensors on ``device``; on the CPU they are views of one host buffer."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device=device) if device.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    errors: list = []

    def _put(item) -> bool:
        """Bounded put that gives up when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def upload(batch):
        keys = list(batch)
        up = Upload.of([np.ascontiguousarray(batch[k]) for k in keys], device)
        return keys, up.send(stream)

    def worker():
        try:
            for batch in iterator:
                if put is not None:
                    batch = put(batch)
                if stop.is_set() or not _put(upload(batch)):
                    return
        except Exception as e:
            errors.append(e)
        finally:
            _put(None)

    threading.Thread(target=worker, daemon=True).start()

    def gen():
        try:
            while True:
                item = q.get()
                if item is None:
                    if errors:
                        raise errors[0]
                    return
                keys, up = item
                yield dict(zip(keys, up.get()))
        finally:
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    return gen()
