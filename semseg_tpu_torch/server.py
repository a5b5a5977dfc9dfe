"""Inference server: dynamic micro-batching over HTTP
(``semseg_tpu/server.py``, the port's own copy).

The module is framework-neutral: the backends do the device work. On the
card, as on the TPU, a bucket's forward gives more images per second at a
larger batch, so a serving host coalesces CONCURRENT requests into batches
rather than dispatching them one by one. ``MicroBatcher`` does that:
requests queue, and a dispatcher thread flushes a batch when either
``max_batch`` requests are pending or the oldest request has waited
``max_wait_ms`` (the classic size-or-deadline policy). One dispatcher
thread per backend also serializes that backend's device access, so HTTP
threads never contend for the device stream.

Backends (anything with ``predict_batch(list[HWC uint8]) -> list[HW int]``):
  * ``serving.Predictor`` — an exported ``torch.export`` bundle; no model
    zoo on the serving host (``python -m
    semseg_tpu_torch.tools.export_serving``).
  * ``LivePredictor`` — the full multi-scale-TTA batched eval engine
    (reference eval protocol quality, heavier per request).

HTTP API (stdlib ``http.server``; zero framework dependencies):
  POST /segment?format=png|color|npy   body = image bytes (JPEG/PNG/...)
      png (default): lossless uint8 label-map PNG (mode L, 0-based ids)
      color:         colorEncode'd RGB PNG (the demo palette)
      npy:           ``np.save`` bytes, int16 labels
  GET /healthz   liveness + backend info
  GET /stats     batching counters: requests, batches, mean batch fill,
                 latency percentiles — the fill number is the knob-tuning
                 signal for ``max_wait_ms``. Latency runs from the enqueue
                 (after any ``preprocess``) to the result, as in the JAX
                 package.
"""

from __future__ import annotations

import io
import json
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

__all__ = [
    "MicroBatcher", "LivePredictor", "SegmentationServer", "QueueFull",
]


class QueueFull(RuntimeError):
    """Admission control: the batcher's queue is at capacity (HTTP 503)."""


class MicroBatcher:
    """Coalesce concurrent ``submit`` calls into ``predict_batch`` calls.

    Flush policy: a batch launches when ``max_batch`` requests are queued,
    or when the OLDEST queued request has waited ``max_wait_ms`` —
    bounding added latency at light load while filling batches under
    concurrency. All device work happens on the one dispatcher thread.

    Admission control: at most ``max_queue`` requests may be pending;
    beyond that ``submit`` raises :class:`QueueFull` so sustained overload
    sheds load (HTTP 503) instead of growing memory without bound.

    Multi-device: pass a LIST of ``predict_batch`` callables (one per
    device) and one dispatcher thread runs per backend, all pulling
    batches off the shared queue.
    """

    def __init__(self, predict_batch, *, max_batch: int = 8,
                 max_wait_ms: float = 10.0, max_queue: int = 128,
                 preprocess=None):
        assert max_batch >= 1 and max_wait_ms >= 0 and max_queue >= 1
        backends = (
            list(predict_batch)
            if isinstance(predict_batch, (list, tuple))
            else [predict_batch]
        )
        assert backends, "need at least one backend"
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.max_wait_s = float(max_wait_ms) / 1e3
        # Optional per-request CPU preprocessing (e.g. the live backend's
        # 5-scale pyramid build) run in the SUBMITTING thread, ahead of
        # the batcher — inside predict_batch it would serialize host work
        # with device dispatch on the one dispatcher thread (the exact
        # pattern the engines' upload pipelining exists to avoid).
        self._preprocess = preprocess
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        # counters (under _cond): completed requests / batches / summed fill
        self._n_requests = 0
        self._n_batches = 0
        self._n_errors = 0
        self._n_rejected = 0
        self._per_backend_batches = [0] * len(backends)
        self._latencies: deque = deque(maxlen=512)  # seconds, completed reqs
        self._threads = [
            threading.Thread(
                target=self._run, args=(i, fn),
                name=f"microbatcher-{i}", daemon=True,
            )
            for i, fn in enumerate(backends)
        ]
        for t in self._threads:
            t.start()

    def _check_admission(self):
        """Closed/capacity checks; call with the lock held."""
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        if len(self._queue) >= self.max_queue:
            self._n_rejected += 1
            raise QueueFull(
                f"{len(self._queue)} requests already queued "
                f"(max_queue={self.max_queue})"
            )

    def submit(self, img: np.ndarray) -> Future:
        """Enqueue one image; resolves to its (H, W) int label map."""
        if self._preprocess is not None:
            # Admission-check BEFORE the expensive preprocess so overload
            # rejection (503) stays cheap — building pyramids for requests
            # that are then shed would deepen the overload. Re-checked at
            # enqueue below (the queue may have filled meanwhile).
            with self._cond:
                self._check_admission()
            img = self._preprocess(img)  # caller thread, outside the lock
        fut: Future = Future()
        with self._cond:
            self._check_admission()
            self._queue.append((img, fut, time.monotonic()))
            self._cond.notify_all()
        return fut

    def _take_batch(self):
        """Block until a batch is due (size or deadline); None = closed.

        With multiple backends, dispatchers COMPETE for the queue: one
        may drain it while another waits on the same deadline. The woken
        loser must go back to sleep (outer loop), not return None — an
        n==0 return while open would kill that dispatcher thread
        permanently, silently degrading N-backend serving to a single
        backend after the first light-load request. The flush deadline is
        also recomputed from the CURRENT queue head after every wakeup:
        batching new arrivals against a stale (earlier) head's deadline
        produced premature under-filled batches.
        """
        with self._cond:
            while True:
                while not self._queue:
                    if self._closed:
                        return None
                    self._cond.wait()
                deadline = self._queue[0][2] + self.max_wait_s
                while (self._queue and len(self._queue) < self.max_batch
                       and not self._closed):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                    if self._queue:  # head may have changed while waiting
                        deadline = self._queue[0][2] + self.max_wait_s
                n = min(len(self._queue), self.max_batch)
                if n:
                    return [self._queue.popleft() for _ in range(n)]
                if self._closed:
                    return None
                # Competing dispatcher drained the queue — wait again.

    def _run(self, backend_idx, predict_batch):
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            imgs = [img for img, _, _ in batch]
            try:
                outs = predict_batch(imgs)
                if len(outs) != len(imgs):
                    raise RuntimeError(
                        f"backend returned {len(outs)} results "
                        f"for {len(imgs)} images"
                    )
            except BaseException as e:  # noqa: BLE001 — forwarded to callers
                with self._cond:
                    self._n_errors += len(batch)
                for _, fut, _ in batch:
                    fut.set_exception(e)
                continue
            done = time.monotonic()
            with self._cond:
                self._n_requests += len(batch)
                self._n_batches += 1
                self._per_backend_batches[backend_idx] += 1
                for _, _, t0 in batch:
                    self._latencies.append(done - t0)
            for (_, fut, _), out in zip(batch, outs):
                fut.set_result(out)

    def stats(self) -> dict:
        with self._cond:
            lats = sorted(self._latencies)
            out = {
                "requests": self._n_requests,
                "batches": self._n_batches,
                "errors": self._n_errors,
                "rejected": self._n_rejected,
                "queued": len(self._queue),
                "max_batch": self.max_batch,
                "max_queue": self.max_queue,
                "max_wait_ms": self.max_wait_s * 1e3,
                "mean_batch_fill": (
                    self._n_requests / self._n_batches
                    if self._n_batches else 0.0
                ),
            }
            if len(self._per_backend_batches) > 1:
                out["backend_batches"] = list(self._per_backend_batches)
        if lats:
            out["latency_ms_p50"] = 1e3 * lats[len(lats) // 2]
            out["latency_ms_p95"] = 1e3 * lats[int(len(lats) * 0.95)
                                               if len(lats) > 1 else 0]
        return out

    def reset_stats(self):
        """Zero the counters/latency window (e.g. after a warmup request,
        whose fill-1 batch would skew the tuning signal)."""
        with self._cond:
            self._n_requests = self._n_batches = 0
            self._n_errors = self._n_rejected = 0
            self._per_backend_batches = [0] * len(self._per_backend_batches)
            self._latencies.clear()

    def close(self):
        """Stop the dispatcher; queued-but-unflushed requests are failed."""
        with self._cond:
            self._closed = True
            pending = list(self._queue)
            self._queue.clear()
            self._cond.notify_all()
        for _, fut, _ in pending:
            fut.set_exception(RuntimeError("MicroBatcher closed"))
        for t in self._threads:
            t.join()


class LivePredictor:
    """``predict_batch`` over the live eval engine (full multi-scale TTA).

    Serving-quality trade vs an exported bundle: the bundle runs ONE scale per
    request (the reference ``test.py`` single-pass protocol); this runs the
    5-scale TTA protocol (reference ``eval.py``) through
    ``BatchedInferenceEngine.batched_predict`` — higher mIoU, ~5x the
    FLOPs. Pyramids are built with the exact dataset transforms (same
    lattice, same Pillow-bit-exact resampling), raw-uint8 transport.
    """

    def __init__(self, cfg_node, engine, *, max_seg_pixels: int = 2 << 20):
        from semseg_tpu_torch.data.dataset import PyramidBuilder

        # ~2.1 MP default (≈1448²): a full-resolution float32 score canvas
        # of (H, W, 150) stays ≤ ~1.3 GB of device memory per request (see
        # preprocess).
        self.max_seg_pixels = int(max_seg_pixels)
        # Caught live by the first verify drive: the plain InferenceEngine
        # has no batched_predict — fail at construction, not per request.
        assert hasattr(engine, "batched_predict"), (
            "LivePredictor needs a BatchedInferenceEngine "
            "(build_engines(..., batch>1))"
        )
        self._engine = engine
        self._ds = PyramidBuilder(
            cfg_node.DATASET, bucket_step=cfg_node.TPU.eval_bucket_step
        )

    def preprocess(self, img):
        """Build the 5-scale pyramid for one request image.

        Wire as ``MicroBatcher(..., preprocess=predictor.preprocess)`` so
        the CPU-side pyramid build runs in the submitting (HTTP handler)
        thread and overlaps device work, instead of serializing with
        dispatch on the dispatcher thread.
        """
        h, w = img.shape[:2]
        # Cap the SCORE-canvas resolution: the on-device accumulate
        # allocates (H, W, num_class) float32 per image, so an untrusted
        # 12-megapixel request (well under the HTTP body cap) would ask
        # for a ~7 GB canvas and OOM the card for every co-batched
        # request. Pyramid scales are already bounded by imgMaxSize; the
        # canvas was not. Oversized requests are scored at the capped
        # resolution and the label map NEAREST-upscaled — the class
        # boundary error is at most the downscale factor in pixels,
        # invisible next to the model's own output stride.
        area = h * w
        if area > self.max_seg_pixels:
            s = (self.max_seg_pixels / area) ** 0.5
            seg = (max(1, round(h * s)), max(1, round(w * s)))
        else:
            seg = (h, w)
        return self._ds.multi_scale_pyramid(img, raw=True), seg, (h, w)

    def predict_batch(self, imgs):
        # Accepts raw (H, W, 3) images (direct library use) or items
        # already built by ``preprocess`` (MicroBatcher wiring above).
        items = [
            it if isinstance(it, tuple) else self.preprocess(it)
            for it in imgs
        ]
        preds = self._engine.batched_predict(
            [p for p, _, _ in items], [s for _, s, _ in items]
        )
        out = []
        for pred, (_, seg, orig) in zip(preds, items):
            if seg != orig:
                from PIL import Image

                pred = np.asarray(
                    Image.fromarray(pred.astype(np.int32), mode="I").resize(
                        (orig[1], orig[0]), Image.NEAREST
                    ),
                    np.int64,
                )
            out.append(pred)
        return out


_MAX_BODY = 64 << 20  # request images are photos, not datasets


class _Handler(BaseHTTPRequestHandler):
    # Socket read timeout: a client that sends Content-Length N but fewer
    # body bytes (slow-loris) must release its handler thread, not leak it.
    timeout = 60

    # The server is long-lived; keep per-request log lines to the access log
    # style (BaseHTTPRequestHandler default), silenceable via quiet=True.
    def log_message(self, fmt, *args):
        if not self.server.quiet:  # type: ignore[attr-defined]
            super().log_message(fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj: dict):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):  # noqa: N802 — http.server API
        path = urlparse(self.path).path
        if path == "/healthz":
            self._send_json(200, {"status": "ok", **self.server.info})
        elif path == "/stats":
            self._send_json(200, self.server.batcher.stats())
        else:
            self._send_json(404, {"error": f"no route {path}"})

    def do_POST(self):  # noqa: N802 — http.server API
        url = urlparse(self.path)
        if url.path != "/segment":
            self._send_json(404, {"error": f"no route {url.path}"})
            return
        fmt = parse_qs(url.query).get("format", ["png"])[0]
        if fmt not in ("png", "color", "npy"):
            self._send_json(400, {"error": f"unknown format {fmt!r}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            length = 0
        if length <= 0:
            self._send_json(400, {"error": "empty body"})
            return
        if length > _MAX_BODY:
            self._send_json(413, {"error": "body too large"})
            return
        try:
            body = self.rfile.read(length)
        except (TimeoutError, OSError):
            return  # truncated/stalled body: nothing sane to answer on

        if len(body) < length:
            self._send_json(400, {"error": "truncated body"})
            return

        from PIL import Image

        try:
            img = np.asarray(
                Image.open(io.BytesIO(body)).convert("RGB"), np.uint8
            )
        except Exception as e:  # noqa: BLE001 — client data
            self._send_json(400, {"error": f"cannot decode image: {e}"})
            return

        try:
            pred = self.server.batcher.submit(img).result(
                timeout=self.server.request_timeout_s
            )
        except QueueFull as e:  # overload: shed, don't grow
            self._send_json(503, {"error": str(e)})
            return
        except FuturesTimeout:  # wedged backend: fail THIS request loudly
            self._send_json(
                504,
                {"error": "prediction timed out "
                          f"({self.server.request_timeout_s}s)"},
            )
            return
        except Exception as e:  # noqa: BLE001 — backend failure -> 500
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            return

        if fmt == "npy":
            buf = io.BytesIO()
            np.save(buf, pred.astype(np.int16), allow_pickle=False)
            self._send(200, buf.getvalue(), "application/x-npy")
            return
        if fmt == "color":
            from semseg_tpu_torch.utils import colorEncode

            arr = colorEncode(pred, mode="RGB").astype(np.uint8)
        else:  # lossless label map: ids < 150 fit uint8 exactly
            arr = pred.astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        self._send(200, buf.getvalue(), "image/png")


class SegmentationServer(ThreadingHTTPServer):
    """HTTP front-end bound to a MicroBatcher.

    ``ThreadingHTTPServer`` gives one thread per connection — those threads
    only decode/encode images and block on futures; ALL device work funnels
    through the batcher's single dispatcher thread.
    """

    daemon_threads = True
    # The listen backlog. socketserver's default of 5 drops the SYNs of a
    # burst of more concurrent clients while the accept loop waits for the
    # interpreter lock, and each dropped client waits a 1 s SYN retry (on an
    # H100 host, 16 clients of a bundle: one request at 1075 ms beside a
    # server-side p95 of 294 ms). The JAX package's copy keeps the default.
    request_queue_size = 128

    def __init__(self, addr, batcher: MicroBatcher, *, info: dict = None,
                 quiet: bool = False, request_timeout_s: float = 300.0):
        self.batcher = batcher
        self.info = dict(info or {})
        self.quiet = quiet
        # Bounds fut.result() so a wedged device runtime turns into 504s
        # (while /healthz keeps answering) instead of silently parking
        # every handler thread forever.
        self.request_timeout_s = request_timeout_s
        super().__init__(addr, _Handler)

    def serve_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def close(self):
        self.shutdown()
        self.server_close()
        self.batcher.close()
