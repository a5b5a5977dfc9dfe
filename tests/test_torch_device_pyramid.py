"""The port's device-pyramid engine against the JAX package's, on the CPU.

* ``pil_resize_matrix`` equals JAX ``_pil_resize_matrix`` within atol 1e-6
  and reproduces ``PIL.Image.resize(BILINEAR)`` within PIL's own 8-bit
  rounding (max 1.3, mean 0.5 grey levels), also inside padded extents;
* ``level_plan`` gives the port ``ValDataset``'s pyramid shapes over random
  sizes, lattices and padding constants; ``ori_canvas`` rounds up;
* the normalized, masked levels equal JAX ``_pyramid_level_fn``'s model
  input within atol 1e-5 (float32 products in another order); products
  over the chunk's largest original equal products over the whole canvas;
* ``batched_metrics_from_originals`` through a narrow float32
  resnet18dilated + ppm_deepsup: the same pixel counts as JAX
  ``DevicePyramidEngine`` and packed vectors within 0.2% of the pixels
  (float32 summation order may flip an argmax on a tie-close pixel; none
  did when written); one window per image equals one window for all;
* the CLI, ``evaluate``'s fallback for oversized originals and the
  engine's canvas check are in ``test_torch_device_pyramid_cli.py``.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from semseg_tpu.engine import DevicePyramidEngine as JaxDevicePyramidEngine
from semseg_tpu.engine import _pil_resize_matrix as jax_pil_resize_matrix
from semseg_tpu.models import decoders as jax_decoders, resnet as jax_resnet
from semseg_tpu.models.segmentation import SegmentationModel as JaxSegmentationModel


from semseg_tpu_torch.config import cfg
from semseg_tpu_torch.data.dataset import BaseDataset, _effective_lattice
from semseg_tpu_torch.engine import BatchedInferenceEngine, DevicePyramidEngine
from semseg_tpu_torch.models import SegmentationModel
from semseg_tpu_torch.models.builder import _init
from semseg_tpu_torch.models.convert import state_dicts_from_jax
from semseg_tpu_torch.models.decoders import PPMDeepsup
from semseg_tpu_torch.models.resnet import ResNetEncoder
from semseg_tpu_torch.ops.resize_dynamic import pil_resize_matrix

from test_torch_model import _perturb_stats, port_weights_for_jax

C = 150
NARROW = dict(layers=(1, 1, 1, 1), planes=(8, 16, 32, 64))
ENGINE = dict(num_class=C, output_stride=8, bucket_step=16, img_sizes=(64, 96),
              img_max_size=160, ori_step=32, ori_canvas=(160, 160))
SHAPES = [(113, 149), (149, 113), (128, 128), (97, 133), (64, 150)]


def _pil_resize(m_h, m_w, ori):
    x = np.einsum("oh,hwc->owc", m_h, ori.astype(np.float32))
    return np.einsum("pw,owc->opc", m_w, x)


@pytest.mark.parametrize("th,tw", [(48, 64), (64, 96), (120, 160), (97, 133)])
def test_pil_resize_matrix_matches_jax_and_pillow(th, tw):
    ori = np.random.RandomState(0).randint(0, 255, (97, 133, 3)).astype(np.uint8)
    m_h = pil_resize_matrix(th, 97, th, 97).numpy()
    m_w = pil_resize_matrix(tw, 133, tw, 133).numpy()
    np.testing.assert_allclose(m_h, np.asarray(jax_pil_resize_matrix(th, 97, th, 97)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(m_w, np.asarray(jax_pil_resize_matrix(tw, 133, tw, 133)),
                               atol=1e-6, rtol=0)
    ref = np.asarray(Image.fromarray(ori).resize((tw, th), Image.BILINEAR), np.float32)
    err = np.abs(_pil_resize(m_h, m_w, ori) - ref)
    # PIL rounds its filter coefficients and its output to 8 bits.
    assert err.max() <= 1.3 and err.mean() <= 0.5, (err.max(), err.mean())


def test_pil_resize_matrix_inside_padded_extents():
    """Runtime sizes inside padded extents give the tight matrices' result,
    batched over per-sample sizes as the engine calls it."""
    ori = np.random.RandomState(1).randint(0, 255, (60, 80, 3)).astype(np.float32)
    want = _pil_resize(pil_resize_matrix(32, 60, 32, 60).numpy(),
                       pil_resize_matrix(48, 80, 48, 80).numpy(), ori)
    padded = np.zeros((128, 128, 3), np.float32)
    padded[:60, :80] = ori
    m_h = pil_resize_matrix(64, 128, torch.tensor([32, 50]), torch.tensor([60, 7]))
    m_w = pil_resize_matrix(64, 128, torch.tensor([48, 3]), torch.tensor([80, 128]))
    assert m_h.shape == m_w.shape == (2, 64, 128)
    np.testing.assert_allclose(m_h[0].numpy(), np.asarray(jax_pil_resize_matrix(64, 128, 32, 60)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(m_w[1].numpy(), np.asarray(jax_pil_resize_matrix(64, 128, 3, 128)),
                               atol=1e-6, rtol=0)
    got = _pil_resize(m_h[0].numpy(), m_w[0].numpy(), padded)
    np.testing.assert_allclose(got[:32, :48], want, atol=1e-3)
    assert np.isfinite(got).all()
    assert (m_h[0, :, 60:] == 0).all() and (m_h[1, :, 7:] == 0).all()


def _plan_engine(sizes, max_size, step):
    return DevicePyramidEngine(None, device="cpu", img_sizes=sizes, img_max_size=max_size,
                               bucket_step=step)


def test_level_plan_matches_the_dataset_over_random_shapes():
    """Two implementations of one lattice contract: any divergence makes
    the device-pyramid and host-pyramid paths score different buckets."""
    rng = np.random.RandomState(11)
    for _ in range(60):
        h, w = int(rng.randint(37, 900)), int(rng.randint(37, 900))
        pad = int(rng.choice([8, 16, 32]))
        bucket = int(rng.choice([0, 8, 16, 24, 32, 48, 64]))
        sizes = tuple(sorted(int(rng.randint(64, 640)) for _ in range(rng.randint(1, 5))))
        max_size = int(rng.randint(max(sizes), 1200))
        opt = cfg.DATASET.clone()
        opt.imgSizes, opt.imgMaxSize, opt.padding_constant = sizes, max_size, pad
        ds = BaseDataset([{"fpath_img": "x", "fpath_segm": "y", "width": w, "height": h}],
                         opt, bucket_step=bucket or None)
        host = [a.shape[1:3] for a in ds.multi_scale_pyramid(
            Image.fromarray(np.zeros((h, w, 3), np.uint8)), raw=True)]
        eng = DevicePyramidEngine(None, device="cpu", img_sizes=sizes, img_max_size=max_size,
                                  bucket_step=bucket, padding_constant=pad)
        assert eng.bucket_step == _effective_lattice(max(bucket, pad), pad)
        assert eng.level_plan(h, w) == host, (h, w, pad, bucket, sizes, max_size)


def test_scalar_img_sizes_and_ori_canvas_rounding():
    eng = _plan_engine(300, 1000, 8)
    assert eng.img_sizes == (300,) and len(eng.level_plan(375, 500)) == 1
    eng = DevicePyramidEngine(None, device="cpu", img_sizes=(64,), img_max_size=160,
                              bucket_step=16, ori_step=64, ori_canvas=(1000, 1500))
    assert eng.ori_canvas == (1024, 1536)
    # 990x1490 fits by its raw size and still fits once padded to the lattice.
    assert eng.fits(990, 1490) and not eng.fits(1025, 10) and not eng.fits(10, 1537)
    assert DevicePyramidEngine(None, device="cpu", img_sizes=(64,), img_max_size=160
                               ).ori_canvas == (1088, 1600)


class _Identity:
    """Stands in for the JAX model: its apply returns the level tensor."""

    @staticmethod
    def apply(variables, x, **kw):
        return x


def _chunk(seed, shapes, targets):
    rng = np.random.RandomState(seed)
    oris = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in shapes]
    hc, wc = 160, 160
    canvas = np.zeros((len(oris), hc, wc, 3), np.uint8)
    for j, o in enumerate(oris):
        canvas[j, :o.shape[0], :o.shape[1]] = o
    ohw = np.array([o.shape[:2] for o in oris], np.int32)
    return canvas, ohw, np.array(targets, np.int32)


def test_levels_match_jax():
    """Normalized, masked levels: targets below and above the originals'
    sizes and inside a larger level bucket."""
    canvas, ohw, thw = _chunk(3, [(113, 149), (64, 150), (97, 40)],
                              [[64, 96], [80, 96], [96, 48]])
    lh, lw = 96, 96
    jax_eng = JaxDevicePyramidEngine(_Identity(), None, bucket_denylist=(), **ENGINE)
    want = np.asarray(jax_eng._pyramid_level_fn(
        None, jnp.asarray(canvas), jnp.asarray(ohw[:, 0]), jnp.asarray(ohw[:, 1]),
        jnp.asarray(thw), lh, lw))
    eng = DevicePyramidEngine(None, device="cpu", **ENGINE)
    got = eng._levels(torch.from_numpy(canvas), torch.from_numpy(ohw), torch.from_numpy(thw),
                      lh, lw)
    assert got.dtype == torch.float32 and got.shape == (3, lh, lw, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    for j, (th, tw) in enumerate(thw):
        assert (got[j, th:] == 0).all() and (got[j, :, tw:] == 0).all()


def test_cropped_canvas_products_equal_full_canvas_ones():
    canvas, ohw, thw = _chunk(4, [(113, 149), (64, 150)], [[64, 96], [80, 96]])
    eng = DevicePyramidEngine(None, device="cpu", **ENGINE)
    args = (torch.from_numpy(ohw), torch.from_numpy(thw), 96, 96)
    crop = torch.from_numpy(np.ascontiguousarray(canvas[:, :128, :160]))
    full = torch.zeros((2, 1088, 1600, 3), dtype=torch.uint8)
    full[:, :160, :160] = torch.from_numpy(canvas)
    a = eng._levels(crop, *args)
    assert torch.equal(a, eng._levels(torch.from_numpy(canvas), *args))
    assert torch.equal(a, eng._levels(full, *args))


@pytest.fixture(scope="module")
def narrow():
    """A narrow float32 resnet18dilated + ppm_deepsup in JAX and its port."""
    model = JaxSegmentationModel(
        encoder=jax_resnet.ResNetEncoder(block="basic", dilate_scale=8, **NARROW),
        decoder=jax_decoders.PPMDeepsup(num_class=C, fc_dim=64), deep_sup_scale=0.4,
    )
    seeded = SegmentationModel(ResNetEncoder(block="basic", dilate_scale=8, **NARROW),
                               PPMDeepsup(num_class=C, fc_dim=64))
    generator = torch.Generator().manual_seed(0)
    _init(seeded.encoder, generator, mode="fan_out", bn_bias=0.0)
    _init(seeded.decoder, generator, mode="fan_in", bn_bias=1e-4)
    # The port's seeded weights on JAX's variables: no JAX init runs.
    variables = port_weights_for_jax(model, seeded, "resnet18dilated", "ppm_deepsup")
    variables = {"params": variables["params"],
                 "batch_stats": _perturb_stats(variables["batch_stats"],
                                               np.random.RandomState(0))}
    enc_sd, dec_sd = state_dicts_from_jax(variables, "resnet18dilated", "ppm_deepsup")
    encoder = ResNetEncoder(block="basic", dilate_scale=8, **NARROW)
    decoder = PPMDeepsup(num_class=C, fc_dim=64)
    encoder.load_state_dict(enc_sd, strict=True)
    decoder.load_state_dict(dec_sd, strict=True)
    port = SegmentationModel(encoder, decoder).eval().to(memory_format=torch.channels_last)
    return model, variables, port


def _originals(seed):
    rng = np.random.RandomState(seed)
    oris = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in SHAPES]
    labels = [rng.randint(-1, C, (h, w)).astype(np.int32) for h, w in SHAPES]
    return oris, labels


def _close(got, want, pix_share):
    for (ga, gp, gi, gu), (wa, wp, wi, wu) in zip(got, want):
        assert int(gp) == int(wp)
        assert abs(float(ga) - float(wa)) <= pix_share * float(wp)
        assert np.abs(gi - wi).sum() <= pix_share * float(wp)
        assert np.abs(gu - wu).sum() <= 2 * pix_share * float(wp)


def test_metrics_from_originals_match_jax(narrow):
    model, variables, port = narrow
    kw = dict(ENGINE, batch_size=2, pack_buckets=True)
    oris, labels = _originals(5)
    eng = DevicePyramidEngine(port, device="cpu", **kw)
    groups = {}
    for i, o in enumerate(oris):
        for th, tw in eng.level_plan(*o.shape[:2]):
            groups.setdefault(eng._bucket_key(th, tw), []).append((i, th, tw))
    packed = eng._pack_groups({k: list(v) for k, v in groups.items()})
    assert len(packed) < len(groups), "the shapes must exercise packing"
    got = eng.batched_metrics_from_originals(oris, labels)
    want = JaxDevicePyramidEngine(model, variables, bucket_denylist=(), fetch_dtype=None,
                                  **kw).batched_metrics_from_originals(oris, labels)
    _close(got, want, 0.002)


def test_one_window_per_image_equals_one_window(narrow):
    """batch_size 1 cuts the originals into windows of 2; a tight canvas
    budget into windows of 1."""
    _, _, port = narrow
    oris, labels = _originals(6)
    whole = DevicePyramidEngine(port, device="cpu", batch_size=8, **ENGINE)
    split = DevicePyramidEngine(port, device="cpu", batch_size=1, **ENGINE)
    tight = DevicePyramidEngine(port, device="cpu", batch_size=2, canvas_budget_mb=1, **ENGINE)
    a = whole.batched_metrics_from_originals(oris, labels)
    for other in (split, tight):
        for x, y in zip(a, other.batched_metrics_from_originals(oris, labels)):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_metrics_from_originals_track_host_pyramids(narrow):
    """Against the batched engine over PIL pyramids of the same plan: only
    the resize backend differs (bounds of the JAX package's own test)."""
    _, _, port = narrow
    oris, labels = _originals(7)
    dev = DevicePyramidEngine(port, device="cpu", batch_size=2, **ENGINE)
    host = BatchedInferenceEngine(port, device="cpu", batch_size=2, num_class=C,
                                  output_stride=8, bucket_step=16)
    pyramids = [[np.asarray(Image.fromarray(o).resize((tw, th), Image.BILINEAR))[None]
                 for th, tw in dev.level_plan(*o.shape[:2])] for o in oris]
    for (ha, hp, hi, hu), (da, dp, di, du) in zip(
            host.batched_metrics(pyramids, labels),
            dev.batched_metrics_from_originals(oris, labels)):
        assert hp == dp
        assert abs(ha - da) / hp < 0.02
        assert np.abs(hi - di).sum() / hp < 0.02
        assert np.abs(hu - du).sum() / hp < 0.04
