"""The port's live serving backend (``semseg_tpu_torch.server.LivePredictor``
over the batched engine) on the CPU, against the JAX package's.

mobilenetv2dilated + ppm_deepsup (fc_dim 320, float32), the weights of
``test_torch_serving.seeded_family``, so the pad-aware pool runs:

* the port's ``LivePredictor`` against JAX's on the same weights, two
  scales, mixed image sizes: argmax agreement >= 0.999 per image;
* the cases of ``tests/test_server_live.py``: a 64x64 image on the one
  pyramid scale equals the model's own forward at full resolution; mixed
  sizes come back at their own size; the preprocess path (MicroBatcher in
  the caller's thread) equals the raw path; the score-canvas cap scores at
  the capped size and NEAREST-upscales.
"""

import numpy as np
import pytest
import torch

from semseg_tpu.config import cfg as jax_cfg
from semseg_tpu.engine import BatchedInferenceEngine as JaxBatchedEngine
from semseg_tpu.server import LivePredictor as JaxLivePredictor

from semseg_tpu_torch.config import cfg
from semseg_tpu_torch.engine import BatchedInferenceEngine
from semseg_tpu_torch.ops.preproc import normalize_255
from semseg_tpu_torch.ops.resize import resize_bilinear
from semseg_tpu_torch.server import LivePredictor, MicroBatcher

from test_torch_serving import seeded_family


def _cfg(node, sizes):
    c = node.clone()
    c.DATASET.imgSizes = sizes
    c.DATASET.imgMaxSize = 128
    c.TPU.eval_bucket_step = 8
    return c


@pytest.fixture(scope="module")
def family():
    return seeded_family(seed=1)


def _engine(port):
    return BatchedInferenceEngine(port, num_class=150, device="cpu", exact=False,
                                  output_stride=8, bucket_step=8, batch_size=2)


@pytest.fixture(scope="module")
def live(family):
    """The port's backend with one pyramid scale (64): the direct-forward
    oracle's setting, as in ``tests/test_server_live.py``."""
    c = _cfg(cfg, (64,))
    engine = _engine(family[2])
    return c, engine, LivePredictor(c, engine)


def _images(seed, shapes):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (*s, 3)).astype(np.uint8) for s in shapes]


def test_live_predictor_matches_jax(family):
    jax_model, variables, port = family
    sizes = (48, 64)
    ref = JaxLivePredictor(_cfg(jax_cfg, sizes), JaxBatchedEngine(
        jax_model, variables, num_class=150, output_stride=8, bucket_step=8,
        batch_size=2, bucket_denylist=()))
    got_backend = LivePredictor(_cfg(cfg, sizes), _engine(port))
    imgs = _images(0, [(50, 70), (64, 64), (70, 50)])
    for img, got, want in zip(imgs, got_backend.predict_batch(imgs), ref.predict_batch(imgs)):
        assert got.shape == want.shape == img.shape[:2]
        assert (got == want).mean() >= 0.999


def test_live_predictor_matches_direct_forward(family, live):
    """64x64 lands on the one pyramid scale and the lattice, so the
    backend's output is the model's own argmax at full resolution."""
    _, _, backend = live
    port = family[2]
    img = _images(1, [(64, 64)])[0]
    got = backend.predict_batch([img])[0]
    assert got.shape == (64, 64)
    with torch.no_grad():
        x = normalize_255(torch.from_numpy(img[None]).to(torch.float32))
        # The engine's call: pad-aware pooling over the whole (unpadded) image.
        logits = port(x.permute(0, 3, 1, 2), valid_hw=torch.tensor([[64, 64]], dtype=torch.int32))
        want = resize_bilinear(logits.to(torch.float32), (64, 64)).argmax(dim=1)[0]
    np.testing.assert_array_equal(got, want.numpy())


def test_live_predictor_mixed_sizes_batch(live):
    c, _, backend = live
    imgs = _images(2, [(50, 70), (64, 64), (90, 40)])
    for img, out in zip(imgs, backend.predict_batch(imgs)):
        assert out.shape == img.shape[:2]
        assert out.min() >= 0 and out.max() < c.DATASET.num_class


def test_live_preprocess_path_matches_raw_path(live):
    """MicroBatcher(preprocess=...) wiring: raw images submitted through
    the batcher (which preprocesses in the caller's thread) give the same
    label maps as predict_batch on raw images."""
    _, _, backend = live
    imgs = _images(3, [(64, 64)] * 3)
    want = backend.predict_batch(list(imgs))
    mb = MicroBatcher(backend.predict_batch, max_batch=2, max_wait_ms=5,
                      preprocess=backend.preprocess)
    try:
        got = [f.result(timeout=60) for f in [mb.submit(im) for im in imgs]]
    finally:
        mb.close()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_live_seg_canvas_cap_upscales_label_map(live):
    """Oversized request images are scored at a capped canvas resolution
    and NEAREST-upscaled back: the canvas (H * W * num_class f32 on the
    device) does not grow with an untrusted request's size."""
    from PIL import Image

    c, engine, _ = live
    capped = LivePredictor(c, engine, max_seg_pixels=32 * 32)
    img = _images(4, [(64, 64)])[0]
    pyr, seg, orig = capped.preprocess(img)
    assert orig == (64, 64) and seg[0] * seg[1] <= 32 * 32
    out = capped.predict_batch([img])[0]
    assert out.shape == (64, 64)
    small = engine.batched_predict([pyr], [seg])[0]
    want = np.asarray(Image.fromarray(small.astype(np.int32), mode="I").resize(
        (64, 64), Image.NEAREST), np.int64)
    np.testing.assert_array_equal(out, want)
