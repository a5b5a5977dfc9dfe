"""The port's serving bundle (``semseg_tpu_torch/serving.py``) against the
JAX package's, on the CPU.

mobilenetv2dilated + ppm_deepsup (fc_dim 320, float32): the JAX model's
variables drawn from a seeded numpy generator in the shapes its ``init``
gives (``jax.eval_shape``: an eager init takes ~25 s on the CPU), carried
into the port by ``state_dicts_from_jax``; buckets 64x64 and 64x96.

* The port's bundle against JAX's ``export_bundle``/``Predictor`` on the
  same weights and images at the bucket shapes: argmax agreement >= 0.999
  per image (float32: the logits agree within ~1e-4, and a pixel whose top
  two logits tie within an ulp may flip). An image of a foreign shape is
  not held to JAX here: the NEAREST resize back multiplies each flipped
  bucket pixel (with these weights, 4 pixels tied within 4.8e-7 at 64x64
  became 6 of 90x60, agreement 0.99889); both predictors resize with the
  same PIL calls.
* The port's bundle bit-equal to the port's eager program on the same
  batch; ``predict_batch`` equal to ``predict``; foreign shapes come back
  at their own size.
* The exported graph holds one ``semseg_tpu_torch.pyramid_pool`` node and
  no ``adaptive_avg_pool2d``; each program file is under 5% of
  ``params.pt``; a bundle exported for another device type is refused.

``cli.serve``'s bundle backend, the HTTP server over a bundle and the
exporter tool are in ``test_torch_serving_cli.py``, so that the two files
run side by side.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semseg_tpu.config import cfg
from semseg_tpu.models import ModelBuilder as JaxModelBuilder
from semseg_tpu.serving import Predictor as JaxPredictor, export_bundle as jax_export_bundle

from semseg_tpu_torch.models import ModelBuilder
from semseg_tpu_torch.models.convert import state_dicts_from_jax
from semseg_tpu_torch.models.segmentation import SegmentationModel
from semseg_tpu_torch.ops.preproc import normalize_255
from semseg_tpu_torch.ops.resize import resize_bilinear
from semseg_tpu_torch.serving import Predictor, export_bundle

SHAPES = [(64, 64), (64, 96)]
ARCH = ("mobilenetv2dilated", "ppm_deepsup")


def _draw(path, leaf, rng):
    name = path[-1].key
    if name == "kernel":  # He-normal over the fan-in (kh * kw * cin)
        return (rng.randn(*leaf.shape) * np.sqrt(2.0 / np.prod(leaf.shape[:-1])))
    if name == "scale":
        return 1.0 + 0.1 * rng.randn(*leaf.shape)
    if name == "var":
        return rng.rand(*leaf.shape) + 0.5
    if name == "iter":  # the SyncBN statistics' step count
        return np.ones(leaf.shape)
    return 0.1 * rng.randn(*leaf.shape)  # biases and running means


def seeded_family(seed=0, fc_dim=320):
    """(JAX model, its variables drawn from numpy with ``seed``, the port's
    model with the same weights, in eval mode on the CPU)."""
    c = cfg.clone()
    c.MODEL.arch_encoder, c.MODEL.arch_decoder, c.MODEL.fc_dim = (*ARCH, fc_dim)
    model = JaxModelBuilder.build_model(c, dtype=jnp.float32)
    keys = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda: model.init(
        keys, jnp.zeros((1, 64, 64, 3)), seg_label=jnp.zeros((1, 8, 8), jnp.int32),
        train=True))
    rng = np.random.RandomState(seed)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, leaf: _draw(p, leaf, rng).astype(np.float32), shapes)
    enc_sd, dec_sd = state_dicts_from_jax(variables, *ARCH)
    port = SegmentationModel(
        ModelBuilder.build_encoder(ARCH[0], fc_dim, device="cpu"),
        ModelBuilder.build_decoder(ARCH[1], fc_dim, encoder_arch=ARCH[0], device="cpu"))
    port.encoder.load_state_dict(enc_sd, strict=True)
    port.decoder.load_state_dict(dec_sd, strict=True)
    return model, variables, port.eval()


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """(port bundle dir, JAX bundle dir, port model), one export each."""
    jax_model, variables, port = seeded_family()
    root = tmp_path_factory.mktemp("bundles")
    jax_export_bundle(jax_model, variables, str(root / "jax"), shapes=SHAPES, batch_size=1,
                      platforms=("cpu",))
    export_bundle(port, str(root / "port"), shapes=SHAPES, batch_size=2)
    return str(root / "port"), str(root / "jax"), port


@pytest.fixture(scope="module")
def predictor(bundles):
    return Predictor(bundles[0], device="cpu")


def _images(seed, shapes):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (*s, 3)).astype(np.uint8) for s in shapes]


def test_bundle_matches_jax_bundle(bundles, predictor):
    imgs = _images(0, [(64, 64), (64, 96), (64, 64), (64, 96), (64, 64)])
    got = predictor.predict_batch(imgs)
    want = JaxPredictor(bundles[1]).predict_batch(imgs)
    for img, g, w in zip(imgs, got, want):
        assert g.shape == img.shape[:2] and g.dtype == np.int64
        assert (g == w).mean() >= 0.999


def test_bundle_equals_eager_program(bundles, predictor):
    model = bundles[2]
    img = _images(1, [(64, 96)])[0]
    got = predictor.predict(img)
    batch = np.zeros((2, 64, 96, 3), np.uint8)  # the program's batch, zero-padded
    batch[0] = img
    with torch.no_grad():
        x = normalize_255(torch.from_numpy(batch).to(torch.float32))
        logits = model(x.permute(0, 3, 1, 2))
        want = resize_bilinear(logits.to(torch.float32), (64, 96)).argmax(dim=1)
    np.testing.assert_array_equal(got, want[0].numpy())


def test_predict_batch_matches_predict(predictor):
    """Packed batched prediction equals one-at-a-time prediction."""
    imgs = _images(2, [(64, 64), (64, 96), (64, 64), (64, 64)])  # an odd-size chunk
    for img, got in zip(imgs, predictor.predict_batch(imgs)):
        np.testing.assert_array_equal(got, predictor.predict(img))


def test_bundle_resizes_foreign_shapes(predictor):
    got = predictor.predict(_images(3, [(50, 70)])[0])
    assert got.shape == (50, 70)
    assert got.min() >= 0 and got.max() < 150


def test_exported_graph_holds_the_pool_op(bundles):
    ep = torch.export.load(os.path.join(bundles[0], "2x64x96.pt2"))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert sum(t.startswith("semseg_tpu_torch.pyramid_pool") for t in targets) == 1
    assert not [t for t in targets if "adaptive_avg_pool" in t]
    # No weights in the program: its only constants are MEAN and STD.
    assert not ep.state_dict
    assert all(v.numel() == 3 for v in ep.constants.values())


def test_program_files_are_small_beside_params(bundles):
    with open(os.path.join(bundles[0], "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["format"] == "semseg_tpu_torch.serving/1" and manifest["device"] == "cpu"
    params = os.path.getsize(os.path.join(bundles[0], "params.pt"))
    for p in manifest["programs"]:
        assert os.path.getsize(os.path.join(bundles[0], p["file"])) <= 0.05 * params


def test_predictor_refuses_a_bundle_for_another_device(bundles, tmp_path):
    import shutil

    moved = tmp_path / "bundle"
    shutil.copytree(bundles[0], moved)
    with open(moved / "manifest.json") as f:
        manifest = json.load(f)
    manifest["device"] = "cuda"
    with open(moved / "manifest.json", "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="exported on 'cuda'"):
        Predictor(str(moved), device="cpu")
