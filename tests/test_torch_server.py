"""The port's serving front end (``semseg_tpu_torch/server.py``): the
micro-batcher's semantics and the HTTP round trips, case for case as
``tests/test_server.py`` holds the JAX package's copy, with stub backends.
The round trips over a real bundle are in ``test_torch_serving_cli.py``,
the live backend in ``test_torch_server_live.py``.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from semseg_tpu_torch.server import MicroBatcher, QueueFull, SegmentationServer


def _red_channel_backend(calls=None, delay=0.0):
    """Stub predict_batch: label map = red channel (identity-checkable)."""

    def predict_batch(imgs):
        if calls is not None:
            calls.append(len(imgs))
        if delay:
            time.sleep(delay)
        return [img[:, :, 0].astype(np.int64) for img in imgs]

    return predict_batch


def _img(rng, h=8, w=10):
    return rng.randint(0, 150, (h, w, 3)).astype(np.uint8)


# ---------------------------------------------------------------- batcher


def test_batcher_results_match_backend_in_order(rng):
    mb = MicroBatcher(_red_channel_backend(), max_batch=4, max_wait_ms=5)
    try:
        imgs = [_img(rng, 6 + i, 9) for i in range(10)]
        futs = [mb.submit(im) for im in imgs]
        for im, f in zip(imgs, futs):
            np.testing.assert_array_equal(f.result(timeout=10), im[:, :, 0])
    finally:
        mb.close()


def test_batcher_coalesces_under_load(rng):
    calls = []
    # Slow backend so the queue builds while batch 1 runs; every flush
    # after the first must then fill to max_batch.
    mb = MicroBatcher(
        _red_channel_backend(calls, delay=0.05), max_batch=4, max_wait_ms=30
    )
    try:
        futs = [mb.submit(_img(rng)) for _ in range(16)]
        for f in futs:
            f.result(timeout=30)
    finally:
        mb.close()
    assert sum(calls) == 16
    assert all(c <= 4 for c in calls)
    assert len(calls) < 16, "no coalescing happened"
    stats = mb.stats()
    assert stats["requests"] == 16
    assert stats["mean_batch_fill"] == pytest.approx(16 / len(calls))
    assert stats["latency_ms_p50"] > 0


def test_batcher_deadline_flush_at_light_load(rng):
    """A single request must not wait for max_batch peers."""
    mb = MicroBatcher(_red_channel_backend(), max_batch=64, max_wait_ms=20)
    try:
        t0 = time.monotonic()
        mb.submit(_img(rng)).result(timeout=10)
        assert time.monotonic() - t0 < 5  # deadline, not starvation
        assert mb.stats()["batches"] == 1
    finally:
        mb.close()


def test_batcher_error_propagates_and_recovers(rng):
    state = {"fail": True}

    def predict_batch(imgs):
        if state["fail"]:
            state["fail"] = False
            raise ValueError("boom")
        return [im[:, :, 0].astype(np.int64) for im in imgs]

    mb = MicroBatcher(predict_batch, max_batch=2, max_wait_ms=5)
    try:
        with pytest.raises(ValueError, match="boom"):
            mb.submit(_img(rng)).result(timeout=10)
        # The dispatcher must survive the failed batch.
        im = _img(rng)
        np.testing.assert_array_equal(
            mb.submit(im).result(timeout=10), im[:, :, 0]
        )
        assert mb.stats()["errors"] == 1
    finally:
        mb.close()


def test_batcher_close_fails_pending_and_rejects_new(rng):
    started = threading.Event()

    def slow(imgs):
        started.set()
        time.sleep(0.3)
        return [im[:, :, 0].astype(np.int64) for im in imgs]

    mb = MicroBatcher(slow, max_batch=1, max_wait_ms=0)
    running = mb.submit(_img(rng))
    started.wait(5)
    queued = mb.submit(_img(rng))  # sits in the queue behind `running`
    mb.close()
    # In-flight work completes; queued-but-unflushed work fails loudly.
    assert running.result(timeout=10).shape == (8, 10)
    with pytest.raises(RuntimeError, match="closed"):
        queued.result(timeout=10)
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(_img(rng))


def test_batcher_wrong_result_count_is_an_error(rng):
    mb = MicroBatcher(lambda imgs: [], max_batch=2, max_wait_ms=5)
    try:
        with pytest.raises(RuntimeError, match="0 results"):
            mb.submit(_img(rng)).result(timeout=10)
    finally:
        mb.close()


def test_batcher_admission_control(rng):
    gate = threading.Event()
    started = threading.Event()

    def blocked(imgs):
        started.set()
        gate.wait(10)
        return [im[:, :, 0].astype(np.int64) for im in imgs]

    mb = MicroBatcher(blocked, max_batch=1, max_wait_ms=0, max_queue=2)
    try:
        running = mb.submit(_img(rng))   # taken by the dispatcher
        started.wait(5)
        queued = [mb.submit(_img(rng)) for _ in range(2)]  # fills the queue
        with pytest.raises(QueueFull, match="max_queue=2"):
            mb.submit(_img(rng))
        assert mb.stats()["rejected"] == 1
        gate.set()                        # drain; accepted work completes
        for f in [running] + queued:
            assert f.result(timeout=10).shape == (8, 10)
    finally:
        gate.set()
        mb.close()


def test_batcher_multi_backend_work_sharing(rng):
    """A list of backends -> one dispatcher per backend, shared queue:
    all results correct, and the work spreads across backends."""
    mb = MicroBatcher(
        [_red_channel_backend(delay=0.05) for _ in range(2)],
        max_batch=2, max_wait_ms=5,
    )
    try:
        imgs = [_img(rng, 6 + i, 9) for i in range(12)]
        futs = [mb.submit(im) for im in imgs]
        for im, f in zip(imgs, futs):
            np.testing.assert_array_equal(f.result(timeout=30), im[:, :, 0])
        stats = mb.stats()
        assert stats["requests"] == 12
        assert sum(stats["backend_batches"]) == stats["batches"]
        # Each 50ms batch blocks its dispatcher, so the other must serve.
        assert all(n > 0 for n in stats["backend_batches"])
    finally:
        mb.close()


def test_batcher_light_load_keeps_all_dispatchers_alive(rng):
    """Regression: with multiple backends, a single light-load request
    wakes every dispatcher at the flush deadline; the losers (empty
    queue after the winner pops) must go back to waiting, not exit.
    Pre-fix, the first light-load request killed N-1 dispatcher threads,
    silently degrading multi-chip serving to a single chip."""
    mb = MicroBatcher(
        [_red_channel_backend(), _red_channel_backend(),
         _red_channel_backend()],
        max_batch=8, max_wait_ms=10,
    )
    try:
        # Several rounds of single-request light load, each of which
        # flushes via the deadline with every dispatcher contending.
        for _ in range(3):
            im = _img(rng)
            np.testing.assert_array_equal(
                mb.submit(im).result(timeout=10), im[:, :, 0]
            )
            time.sleep(0.05)  # let losing dispatchers hit the n==0 path
        assert all(t.is_alive() for t in mb._threads), (
            "dispatcher thread(s) died under light load"
        )
        # And the batcher still serves across backends afterwards.
        futs = [mb.submit(_img(rng)) for _ in range(12)]
        for f in futs:
            f.result(timeout=10)
    finally:
        mb.close()


def test_batcher_reset_stats(rng):
    mb = MicroBatcher(_red_channel_backend(), max_batch=2, max_wait_ms=5)
    try:
        mb.submit(_img(rng)).result(timeout=10)
        assert mb.stats()["requests"] == 1
        mb.reset_stats()
        s = mb.stats()
        assert s["requests"] == 0 and s["batches"] == 0
        assert "latency_ms_p50" not in s
    finally:
        mb.close()


# ------------------------------------------------------------------ HTTP


@pytest.fixture
def http_server(rng):
    mb = MicroBatcher(_red_channel_backend(), max_batch=4, max_wait_ms=5)
    srv = SegmentationServer(
        ("127.0.0.1", 0), mb, info={"backend": "stub"}, quiet=True
    )
    srv.serve_background()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.close()


def _post(url, data, timeout=30):
    req = urllib.request.Request(url, data=data, method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def _png_bytes(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_http_segment_png_round_trip(http_server, rng):
    from PIL import Image

    img = _img(rng, 12, 7)
    resp = _post(http_server + "/segment", _png_bytes(img))
    assert resp.status == 200
    assert resp.headers["Content-Type"] == "image/png"
    got = np.asarray(Image.open(io.BytesIO(resp.read())))
    np.testing.assert_array_equal(got, img[:, :, 0])


def test_http_segment_npy_and_color(http_server, rng):
    from PIL import Image

    from semseg_tpu_torch.utils import colorEncode

    img = _img(rng, 9, 11)
    raw = np.load(
        io.BytesIO(_post(http_server + "/segment?format=npy",
                         _png_bytes(img)).read())
    )
    assert raw.dtype == np.int16
    np.testing.assert_array_equal(raw, img[:, :, 0])

    resp = _post(http_server + "/segment?format=color", _png_bytes(img))
    got = np.asarray(Image.open(io.BytesIO(resp.read())))
    want = colorEncode(img[:, :, 0].astype(np.int64), mode="RGB")
    np.testing.assert_array_equal(got, want)


def test_http_healthz_and_stats(http_server, rng):
    health = json.load(urllib.request.urlopen(http_server + "/healthz"))
    assert health["status"] == "ok" and health["backend"] == "stub"

    _post(http_server + "/segment", _png_bytes(_img(rng))).read()
    stats = json.load(urllib.request.urlopen(http_server + "/stats"))
    assert stats["requests"] >= 1 and stats["batches"] >= 1


def test_http_error_statuses(http_server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(http_server + "/segment", b"not an image")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(http_server + "/segment?format=bmp", b"x")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(http_server + "/segment", b"")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(http_server + "/nope")
    assert e.value.code == 404


class _StuntBatcher:
    """Stand-in batcher driving the handler's overload/timeout branches."""

    def __init__(self, mode):
        self.mode = mode

    def submit(self, img):
        if self.mode == "full":
            raise QueueFull("7 requests already queued (max_queue=4)")
        from concurrent.futures import Future

        return Future()  # never resolves -> handler 504s on its deadline

    def stats(self):
        return {}

    def close(self):
        pass


@pytest.mark.parametrize("mode,code", [("full", 503), ("hang", 504)])
def test_http_overload_and_timeout_statuses(mode, code, rng):
    srv = SegmentationServer(
        ("127.0.0.1", 0), _StuntBatcher(mode), quiet=True,
        request_timeout_s=0.2,
    )
    srv.serve_background()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/segment"
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, _png_bytes(_img(rng)))
        assert e.value.code == code
    finally:
        srv.close()


def test_http_truncated_body_releases_thread(http_server, rng):
    """Content-Length lies, client half-closes: 400, and the server keeps
    serving (the handler thread is not parked on rfile.read)."""
    import socket

    host, port = http_server.rsplit(":", 1)[0][7:], int(http_server.rsplit(":", 1)[1])
    s = socket.create_connection((host, port), timeout=10)
    s.sendall(
        b"POST /segment HTTP/1.1\r\nHost: x\r\n"
        b"Content-Length: 1000\r\n\r\nonly-a-few-bytes"
    )
    s.shutdown(socket.SHUT_WR)
    reply = s.recv(4096)
    s.close()
    assert b"400" in reply.split(b"\r\n", 1)[0]
    # Server still answers real requests afterwards.
    resp = _post(http_server + "/segment", _png_bytes(_img(rng)))
    assert resp.status == 200


def test_http_concurrent_requests_batch_on_device(http_server, rng):
    """N parallel HTTP clients end up coalesced by the one dispatcher."""
    imgs = [_img(rng, 8, 8) for _ in range(8)]
    outs = [None] * 8

    def post(i):
        from PIL import Image

        resp = _post(http_server + "/segment", _png_bytes(imgs[i]))
        outs[i] = np.asarray(Image.open(io.BytesIO(resp.read())))

    threads = [threading.Thread(target=post, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for img, out in zip(imgs, outs):
        np.testing.assert_array_equal(out, img[:, :, 0])


def test_batcher_preprocess_runs_in_caller_and_respects_admission(rng):
    """preprocess runs in the submitting thread (items reach the backend
    already transformed), and overload rejection stays CHEAP: a full
    queue raises QueueFull BEFORE the preprocess callback runs."""
    calls = []

    def preprocess(img):
        calls.append(threading.get_ident())
        return (img, img.shape[:2])

    def backend(items):
        # items must be the preprocessed tuples, not raw arrays
        assert all(isinstance(it, tuple) for it in items)
        return [np.full(shape, 7, np.int64) for _, shape in items]

    blocked = threading.Event()
    started = threading.Event()

    def slow_backend(items):
        started.set()
        blocked.wait(30)
        return backend(items)

    mb = MicroBatcher(slow_backend, max_batch=1, max_wait_ms=0, max_queue=2,
                      preprocess=preprocess)
    try:
        futs = [mb.submit(_img(rng))]     # taken by the dispatcher…
        started.wait(5)                   # …wait until it actually is
        futs += [mb.submit(_img(rng)) for _ in range(2)]  # fills the queue
        n_before = len(calls)
        with pytest.raises(QueueFull):
            mb.submit(_img(rng))
        assert len(calls) == n_before, (
            "preprocess ran for a request that admission control rejected"
        )
        assert all(t == threading.get_ident() for t in calls), (
            "preprocess escaped the submitting thread"
        )
        blocked.set()
        for f in futs:
            assert f.result(timeout=30).shape == (8, 10)
    finally:
        blocked.set()
        mb.close()


def test_batcher_multi_backend_stress(rng):
    """Randomized stress over the competing-dispatcher path: mixed burst/
    idle submission against 4 backends with jittered service times. Locks
    in the _take_batch loop semantics (no lost wakeups, no dead
    dispatchers, no dropped or double-completed requests)."""
    import random

    r = random.Random(0)

    def jittery_backend():
        def predict_batch(imgs):
            time.sleep(r.uniform(0, 0.01))
            return [img[:, :, 0].astype(np.int64) for img in imgs]

        return predict_batch

    mb = MicroBatcher(
        [jittery_backend() for _ in range(4)], max_batch=3, max_wait_ms=5,
        max_queue=1000,
    )
    try:
        futs = []
        imgs = []
        for i in range(120):
            im = _img(rng, 5 + (i % 7), 9)
            imgs.append(im)
            futs.append(mb.submit(im))
            if i % 17 == 0:
                time.sleep(0.02)  # idle gaps force deadline flushes
        for im, f in zip(imgs, futs):
            np.testing.assert_array_equal(f.result(timeout=30), im[:, :, 0])
        stats = mb.stats()
        assert stats["requests"] == 120
        assert stats["errors"] == 0
        assert all(t.is_alive() for t in mb._threads)
    finally:
        mb.close()
    assert all(not t.is_alive() for t in mb._threads)


# ------------------------------------------- beyond tests/test_server.py


def test_http_backend_failure_is_500_and_oversized_body_413(rng):
    import socket

    def failing(imgs):
        raise ValueError("backend down")

    mb = MicroBatcher(failing, max_batch=2, max_wait_ms=5)
    srv = SegmentationServer(("127.0.0.1", 0), mb, quiet=True)
    srv.serve_background()
    try:
        port = srv.server_address[1]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"http://127.0.0.1:{port}/segment", _png_bytes(_img(rng)))
        assert e.value.code == 500
        assert "ValueError: backend down" in json.load(e.value)["error"]
        # A Content-Length over the 64 MB cap is refused before any read.
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(b"POST /segment HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Length: %d\r\n\r\n" % ((64 << 20) + 1))
        reply = s.recv(4096)
        s.close()
        assert b"413" in reply.split(b"\r\n", 1)[0]
    finally:
        srv.close()


def test_stats_latency_runs_from_enqueue_after_preprocess(rng):
    """As in the JAX package, /stats latency leaves the caller-side
    preprocess out: it runs from the enqueue to the result."""

    def slow_preprocess(img):
        time.sleep(0.3)
        return img

    mb = MicroBatcher(_red_channel_backend(), max_batch=1, max_wait_ms=0,
                      preprocess=slow_preprocess)
    try:
        t0 = time.monotonic()
        mb.submit(_img(rng)).result(timeout=10)
        assert time.monotonic() - t0 >= 0.3
        assert mb.stats()["latency_ms_p50"] < 250
    finally:
        mb.close()


def test_http_listen_backlog_takes_a_burst_of_clients():
    """A burst of concurrent connections waits in the listen backlog for
    the accept loop; socketserver's default backlog of 5 would drop the
    7th client's SYN and leave it to a 1 s retry."""
    import socket

    mb = MicroBatcher(_red_channel_backend(), max_batch=4, max_wait_ms=5)
    srv = SegmentationServer(("127.0.0.1", 0), mb, quiet=True)  # listening, not accepting
    socks = []
    try:
        for _ in range(32):
            socks.append(socket.create_connection(srv.server_address, timeout=0.5))
    finally:
        for s in socks:
            s.close()
        srv.server_close()
        mb.close()
    assert len(socks) == 32
