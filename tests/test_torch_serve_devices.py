"""``cli.serve --devices N`` on the CPU: N backends behind one batcher.

The JAX CLI builds one backend per chip and one dispatcher thread per
backend off the shared queue (``semseg_tpu/cli/serve.py:23-107``); the
port does the same per card. Here two live backends (resnet18dilated +
ppm_deepsup, seeded random weights, tiny scales) share the CPU (``--device
cpu --devices 2``) and answer ``/segment`` with the bytes one backend
gives, and both dispatchers take batches of a burst. Two bundle backends:
``test_torch_serving_cli.py::test_serve_cli_builds_bundle_backend``.
Asking for more cards than are visible exits at start, as in JAX.
"""

import argparse
import io
import os
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image

from semseg_tpu_torch.cli import serve as serve_cli
from semseg_tpu_torch.config import cfg
from semseg_tpu_torch.models import ModelBuilder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG18 = os.path.join(ROOT, "config", "ade20k-resnet18dilated-ppm_deepsup.yaml")
SHAPES = [(64, 64), (48, 80), (64, 64), (80, 48), (64, 64), (56, 72)]


def _bodies():
    rng = np.random.RandomState(8)
    out = []
    for h, w in SHAPES:
        buf = io.BytesIO()
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(buf, "PNG")
        out.append(buf.getvalue())
    return out


def _serve(argv, rounds):
    """Raw ``/segment?format=npy`` answers of a server built from ``argv``
    to each round of ``(bodies, client threads)``, the batches each
    backend ran (one entry for one backend), and ``info['devices']``."""
    srv, backends = serve_cli.build_server(
        ["--host", "127.0.0.1", "--port", "0", "--quiet", "--device", "cpu", *argv])
    srv.serve_background()
    url = f"http://127.0.0.1:{srv.server_address[1]}/segment?format=npy"

    def post(body):
        req = urllib.request.Request(url, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.read()

    try:
        answers = []
        for bodies, clients in rounds:
            with ThreadPoolExecutor(clients) as pool:
                answers.append(list(pool.map(post, bodies)))
        stats = srv.batcher.stats()
    finally:
        srv.close()
    return answers, stats.get("backend_batches", [stats["batches"]]), srv.info["devices"]


@pytest.fixture(scope="module")
def live_ckpt(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    c = cfg.clone()
    c.merge_from_file(CFG18)
    model = ModelBuilder.build_model(c, device="cpu", seed=2)
    for part in ("encoder", "decoder"):
        torch.save(getattr(model, part).state_dict(), os.path.join(ckpt, f"{part}_epoch_20.pth"))
    return ckpt


def test_two_backends_serve_one_backends_bytes(live_ckpt):
    argv = ["--cfg", CFG18, "--max-batch", "2", "DIR", live_ckpt,
            "DATASET.imgSizes", "(40, 56)", "DATASET.imgMaxSize", "96",
            "TPU.compute_dtype", "float32"]
    bodies = _bodies()
    (one,), _, n1 = _serve(argv, [(bodies, 1)])
    # One client: each request alone in its batch, on either backend. Four:
    # both dispatchers take batches; the engine then packs levels of
    # co-batched requests into shared buckets, whose extra pad moves their
    # maps (phase 9 of chip_smoke.py), so only their shapes are held there.
    (alone, burst), per_backend, n2 = _serve(["--devices", "2", *argv],
                                             [(bodies, 1), (bodies * 2, 4)])
    assert (n1, n2) == (1, 2)
    assert len(per_backend) == 2 and min(per_backend) > 0, per_backend
    assert alone == one
    for k, answer in enumerate(burst):
        assert np.load(io.BytesIO(answer)).shape == SHAPES[k % len(bodies)], k


def test_more_devices_than_visible_exit(tmp_path, monkeypatch):
    """Before any backend is built (the bundle is never read)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    args = argparse.Namespace(bundle=str(tmp_path / "none"), cfg=None, device="cuda",
                              devices=2)
    with pytest.raises(SystemExit, match="--devices 2 requested but only 1"):
        serve_cli.build_backends(args, [])
    # One card, named: N backends on it, nothing to count.
    assert serve_cli.serve_devices("cuda:0", 2) == [torch.device("cuda", 0)] * 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert serve_cli.serve_devices("cuda", 3) == [torch.device("cuda", i) for i in range(3)]
