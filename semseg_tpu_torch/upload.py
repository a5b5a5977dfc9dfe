"""Host arrays to the device in one coalesced copy, shared by the eval
engines (``engine.py``) and the trainer's prefetch (``parallel/mesh.py``)."""

from __future__ import annotations

import numpy as np
import torch

_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int32): torch.int32,
                 np.dtype(np.float32): torch.float32}


class Upload:
    """Host arrays packed into one buffer that reaches the device in one copy.

    For a card the buffer is pinned and the copy runs on ``stream`` (a side
    stream), followed by an event; ``get`` makes the caller's current stream
    wait on that event and marks the device buffer as used there
    (``record_stream``), so the allocator does not hand its memory back to
    the side stream while the compute stream still reads it. The pinned
    buffer itself is safe to drop at once: PyTorch's host allocator does not
    reuse a pinned block before the copies that read it have completed.
    """

    def __init__(self, specs, device: torch.device):
        self.device = device
        self._layout, total = [], 0
        for shape, dtype in specs:
            dtype = np.dtype(dtype)
            total = -(-total // 16) * 16
            nbytes = int(np.prod(shape)) * dtype.itemsize
            self._layout.append((total, nbytes, tuple(shape), dtype))
            total += nbytes
        self.host = torch.zeros(total, dtype=torch.uint8,
                                pin_memory=device.type == "cuda")
        buf = self.host.numpy()
        #: numpy views to fill before ``send``.
        self.arrays = [buf[o:o + n].view(dt).reshape(shape)
                       for o, n, shape, dt in self._layout]
        self._dev = None
        self._event = None

    @classmethod
    def of(cls, arrays, device):
        up = cls([(a.shape, a.dtype) for a in arrays], device)
        for dst, src in zip(up.arrays, arrays):
            dst[...] = src
        return up

    def send(self, stream=None) -> "Upload":
        if self.device.type != "cuda":
            self._dev = self.host
            return self
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            self._dev = self.host.to(self.device, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        return self

    def get(self):
        """Device views of the arrays, ready on the current stream."""
        if self._event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(self._event)
            self._dev.record_stream(current)
        return [self._dev[o:o + n].view(_TORCH_DTYPES[dt]).view(shape)
                for o, n, shape, dt in self._layout]
