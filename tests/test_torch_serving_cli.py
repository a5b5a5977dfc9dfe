"""``cli.serve``'s bundle backend, the HTTP server over a bundle and the
exporter tool (``semseg_tpu_torch.tools.export_serving``), on the CPU; the
JAX counterparts are ``tests/test_server.py::test_serve_cli_builds_bundle_backend``
and ``::test_server_over_aot_bundle``. The bundle's parity with JAX's is in
``test_torch_serving.py``.
"""

import argparse
import io
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from semseg_tpu_torch.config import cfg
from semseg_tpu_torch.models import ModelBuilder
from semseg_tpu_torch.serving import Predictor, export_bundle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A seeded mobilenetv2dilated + ppm_deepsup (fc_dim 320) bundle, 64x64, batch 2."""
    c = cfg.clone()
    c.MODEL.arch_encoder, c.MODEL.arch_decoder, c.MODEL.fc_dim = (
        "mobilenetv2dilated", "ppm_deepsup", 320)
    c.TPU.compute_dtype = "float32"
    out = str(tmp_path_factory.mktemp("bundle"))
    export_bundle(ModelBuilder.build_model(c, device="cpu"), out, shapes=[(64, 64)],
                  batch_size=2)
    return out


@pytest.fixture(scope="module")
def predictor(bundle):
    return Predictor(bundle, device="cpu")


def _image(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, (*shape, 3)).astype(np.uint8)


def test_serve_cli_builds_bundle_backend(bundle, predictor):
    from semseg_tpu_torch.cli.serve import build_backends

    args = argparse.Namespace(bundle=bundle, cfg=None, device="cpu")
    (backend,), info, warmup = build_backends(args, [])
    assert info["backend"] == "bundle" and info["programs"] == ["2x64x64"]
    warmup()
    img = _image(4, (64, 64))
    np.testing.assert_array_equal(backend.predict_batch([img])[0], predictor.predict(img))
    with pytest.raises(SystemExit, match="no effect"):
        build_backends(args, ["TEST.checkpoint", "x.pth"])
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        build_backends(argparse.Namespace(bundle=bundle, cfg=None, device="cpu",
                                          devices=2), [])


def test_server_over_bundle(bundle, predictor):
    """End to end: the bundle behind the HTTP endpoint."""
    from PIL import Image

    from semseg_tpu_torch.cli.serve import build_server

    srv, _ = build_server(["--bundle", bundle, "--device", "cpu", "--host", "127.0.0.1",
                           "--port", "0", "--no-warmup", "--quiet", "--max-batch", "2"])
    srv.serve_background()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        img = _image(5, (64, 64))
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        req = urllib.request.Request(url + "/segment?format=npy", data=buf.getvalue(),
                                     method="POST")
        raw = np.load(io.BytesIO(urllib.request.urlopen(req, timeout=60).read()))
        want = predictor.predict(img)
        np.testing.assert_array_equal(raw, want.astype(np.int16))
        health = json.load(urllib.request.urlopen(url + "/healthz", timeout=10))
        assert health["backend"] == "bundle"
    finally:
        srv.close()


def test_export_tool_checks_shapes_and_exports(tmp_path):
    from semseg_tpu_torch.tools import export_serving

    path = os.path.join(ROOT, "config", "ade20k-mobilenetv2dilated-c1_deepsup.yaml")
    c = cfg.clone()
    c.merge_from_file(path)
    model = ModelBuilder.build_model(c, device="cpu")
    for name, module in (("encoder", model.encoder), ("decoder", model.decoder)):
        torch.save(module.state_dict(), tmp_path / f"{name}_epoch_20.pth")
    argv = ["--cfg", path, "--out", str(tmp_path / "bundle"), "--device", "cpu",
            "--shapes", "32x40", "DIR", str(tmp_path), "TEST.checkpoint", "epoch_20.pth"]
    with pytest.raises(ValueError, match="padding_constant"):
        export_serving.main([*argv[:-6], "--shapes", "30x40", *argv[-4:]])
    manifest = export_serving.main(argv)
    assert [p["file"] for p in manifest["programs"]] == ["1x32x40.pt2"]
    got = Predictor(str(tmp_path / "bundle"), device="cpu").predict(_image(6, (32, 40)))
    assert got.shape == (32, 40)
