"""The port's data layer on its native path against the JAX package's.

The same seeded JPEG training set and odgt go through the port's
``TrainDataset`` and JAX's with the same flags and seed: several batches
must be equal bit for bit, with the exact decode and with ``fast_decode``
(the DCT-domain reduced decode of ``TPU.train_fast_decode``), uint8 and
float32. The val pyramids of the port's native path equal JAX's native ones
and the port's own with ``SEMSEG_NO_NATIVE=1`` (PIL). ``cli.train`` trains
with ``TPU.train_fast_decode True``.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

import semseg_tpu.data as jax_data
import semseg_tpu.native as jax_native
import semseg_tpu_torch.data as port_data
import semseg_tpu_torch.native as native
from semseg_tpu.config import cfg as jax_cfg
from semseg_tpu_torch.config import cfg as port_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "config", "ade20k-resnet50dilated-ppm_deepsup.yaml")
# Both orientations (aspect bins), sizes whose targets take DCT scales 2-7.
SHAPES = [(200, 260), (260, 200), (150, 220), (230, 170), (176, 240), (240, 176)]
OPTS = ["DATASET.imgSizes", "(48, 64, 96)", "DATASET.imgMaxSize", "160"]


def _opt(base):
    c = base.clone()
    c.merge_from_file(CFG)
    c.merge_from_list(list(OPTS))
    return c.DATASET


@pytest.fixture(scope="module")
def jpeg_set(tmp_path_factory):
    if not jax_native.jpeg_available():
        pytest.skip("the JAX package's native library has no libjpeg here")
    assert native.jpeg_available(), native.build_info()
    root = tmp_path_factory.mktemp("train")
    rng = np.random.RandomState(0)
    recs = []
    for i, (h, w) in enumerate(SHAPES):
        # Smooth content plus noise: the decode's upsampling paths all matter.
        yy, xx = np.mgrid[:h, :w]
        img = np.stack([yy * 255 // h, xx * 255 // w, (yy + xx) * 255 // (h + w)], -1)
        img = np.clip(img + rng.randint(-20, 21, img.shape), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(root / f"{i}.jpg", quality=90, subsampling=i % 2 * 2)
        Image.fromarray(rng.randint(0, 151, (h, w)).astype(np.uint8), "L").save(root / f"{i}.png")
        recs.append({"fpath_img": f"{i}.jpg", "fpath_segm": f"{i}.png", "height": h, "width": w})
    odgt = root / "train.odgt"
    odgt.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return str(root), str(odgt)


def _batches(mod, base, root, odgt, n=4, **kw):
    ds = mod.TrainDataset(root, odgt, _opt(base), batch_per_gpu=2, seed=11,
                          bucket_step=16, **kw)
    return [ds.next_batch() for _ in range(n)]


@pytest.mark.parametrize("fast_decode", [False, True], ids=["exact", "fast_decode"])
@pytest.mark.parametrize("raw_transport", [True, False], ids=["uint8", "float32"])
def test_train_batches_equal_jax(jpeg_set, fast_decode, raw_transport):
    root, odgt = jpeg_set
    kw = dict(fast_decode=fast_decode, raw_transport=raw_transport)
    port = _batches(port_data, port_cfg, root, odgt, **kw)
    ref = _batches(jax_data, jax_cfg, root, odgt, **kw)
    for p, r in zip(port, ref):
        assert sorted(p) == sorted(r)
        for k in r:
            assert p[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(p[k], r[k], err_msg=k)


def test_fast_decode_takes_the_reduced_decode(jpeg_set, monkeypatch):
    """``fast_decode`` reaches ``decode_jpeg`` at scales below 8 (the
    reduced decode ran, not the exact one), and the labels are the exact
    path's."""
    root, odgt = jpeg_set
    scales = []
    real = native.decode_jpeg

    def spy(data, scale_num=8):
        scales.append(scale_num)
        return real(data, scale_num)

    monkeypatch.setattr(native, "decode_jpeg", spy)
    fast = _batches(port_data, port_cfg, root, odgt, n=2, fast_decode=True)
    exact = _batches(port_data, port_cfg, root, odgt, n=2)
    assert scales and all(1 <= s < 8 for s in scales), scales
    for f, e in zip(fast, exact):
        np.testing.assert_array_equal(f["seg_label"], e["seg_label"])
        assert f["img_data"].shape == e["img_data"].shape


def test_native_train_batches_equal_pil(jpeg_set, monkeypatch):
    """The exact native path gives the PIL path's uint8 batches bit for bit."""
    root, odgt = jpeg_set
    native_b = _batches(port_data, port_cfg, root, odgt, n=3, raw_transport=True)
    monkeypatch.setenv("SEMSEG_NO_NATIVE", "1")
    pil_b = _batches(port_data, port_cfg, root, odgt, n=3, raw_transport=True)
    for a, b in zip(native_b, pil_b):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("device_preprocess,bucket_step", [(True, 8), (False, None)])
def test_val_pyramids_equal_jax_and_pil(jpeg_set, monkeypatch, device_preprocess, bucket_step):
    root, odgt = jpeg_set
    kw = dict(device_preprocess=device_preprocess, bucket_step=bucket_step)
    port = port_data.ValDataset(root, odgt, _opt(port_cfg), **kw)
    ref = jax_data.ValDataset(root, odgt, _opt(jax_cfg), **kw)
    port_items = [port[i] for i in range(len(port))]
    for i, item in enumerate(port_items):
        r = ref[i]
        np.testing.assert_array_equal(item["img_ori"], r["img_ori"])
        assert len(item["img_data"]) == len(r["img_data"]) == 3
        for a, b in zip(item["img_data"], r["img_data"]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    monkeypatch.setenv("SEMSEG_NO_NATIVE", "1")
    for i, item in enumerate(port_items):
        p = port[i]
        np.testing.assert_array_equal(item["img_ori"], p["img_ori"])
        for a, b in zip(item["img_data"], p["img_data"]):
            np.testing.assert_array_equal(a, b)


def test_cli_train_with_fast_decode(jpeg_set, tmp_path):
    """``TPU.train_fast_decode True`` trains through ``cli.train`` (a narrow
    model: resnet18dilated + c1_deepsup, 2 steps on the CPU)."""
    from semseg_tpu_torch.cli import train as train_cli

    root, odgt = jpeg_set
    state, history = train_cli.main([
        "--device", "cpu", "--cfg", CFG, "DIR", str(tmp_path / "run"),
        "DATASET.root_dataset", root, "DATASET.list_train", odgt, *OPTS,
        "MODEL.arch_encoder", "resnet18dilated", "MODEL.arch_decoder", "c1_deepsup",
        "MODEL.fc_dim", "512", "MODEL.pretrained_encoder", "False",
        "TPU.compute_dtype", "float32", "TPU.train_fast_decode", "True",
        "TRAIN.num_epoch", "1", "TRAIN.epoch_iters", "2", "TRAIN.disp_iter", "1",
        "TRAIN.workers", "1",
    ])
    assert state.step == 2
    assert all(np.isfinite(history["train"]["loss"]))
    assert os.path.exists(tmp_path / "run" / "encoder_epoch_1.pth")
