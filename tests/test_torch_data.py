"""The port's copies of the framework-neutral modules equal the JAX package's.

``semseg_tpu_torch.{config, data, utils}`` are copies of the JAX package's
modules, so that the port imports nothing of ``semseg_tpu``. These tests hold
each copy to its original on seeded synthetic inputs: the merged config,
the eval/test pyramids (uint8 on the step-8 lattice, float for ``--exact``,
none for originals that fit a device-pyramid canvas),
the lattice rounding and the metrics. Equality is exact throughout.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

import semseg_tpu.config as jax_config
import semseg_tpu.data as jax_data
import semseg_tpu.data.dataset as jax_dataset
import semseg_tpu.utils as jax_utils
import semseg_tpu_torch.config as port_config
import semseg_tpu_torch.data as port_data
import semseg_tpu_torch.data.dataset as port_dataset
import semseg_tpu_torch.utils as port_utils

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "config", "ade20k-resnet50dilated-ppm_deepsup.yaml")
SHAPES = [(61, 83), (90, 47), (40, 40)]
SIZES = "(48, 64, 72)"


def _cfg(mod, *opts):
    cfg = mod.cfg.clone()
    cfg.merge_from_file(CFG)
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg


@pytest.mark.parametrize("opts", [
    (),
    ("DATASET.imgSizes", SIZES, "TPU.compute_dtype", "float32", "TPU.eval_bucket_step", "16"),
])
def test_cfg_merges_the_same(opts):
    assert _cfg(port_config, *opts).dump() == _cfg(jax_config, *opts).dump()


@pytest.mark.parametrize("name", sorted(
    p for p in os.listdir(os.path.join(ROOT, "config")) if p.endswith(".yaml")))
def test_every_shipped_config_merges_the_same(name):
    path = os.path.join(ROOT, "config", name)
    port, ref = port_config.cfg.clone(), jax_config.cfg.clone()
    port.merge_from_file(path)
    ref.merge_from_file(path)
    assert port.dump() == ref.dump()


@pytest.fixture(scope="module")
def val_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("val")
    rng = np.random.RandomState(0)
    records = []
    for i, (h, w) in enumerate(SHAPES):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        # One PNG (lossless) and JPEGs (the decoders' JPEG route).
        ext = "png" if i == 0 else "jpg"
        Image.fromarray(img).save(root / f"img{i}.{ext}", quality=90)
        seg = rng.randint(0, 151, (h, w)).astype(np.uint8)
        Image.fromarray(seg, mode="L").save(root / f"seg{i}.png")
        records.append({"fpath_img": f"img{i}.{ext}", "fpath_segm": f"seg{i}.png",
                        "height": h, "width": w})
    odgt = root / "val.odgt"
    odgt.write_text("".join(json.dumps(r) + "\n" for r in records))
    return str(root), str(odgt)


# (device_preprocess, bucket_step): the default eval path's uint8 levels on
# the step-8 lattice, a coarser lattice, and --exact's float levels.
PYRAMID_MODES = [(True, 8), (True, 32), (False, None)]


@pytest.mark.parametrize("device_preprocess,bucket_step", PYRAMID_MODES)
def test_val_dataset_pyramids_equal(val_set, device_preprocess, bucket_step):
    root, odgt = val_set
    opt = _cfg(port_config, "DATASET.imgSizes", SIZES).DATASET
    kw = dict(device_preprocess=device_preprocess, bucket_step=bucket_step)
    port = port_data.ValDataset(root, odgt, opt, **kw)
    ref = jax_data.ValDataset(root, odgt, opt, **kw)
    assert len(port) == len(ref) == len(SHAPES)
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        assert a["info"] == b["info"]
        np.testing.assert_array_equal(a["img_ori"], b["img_ori"])
        np.testing.assert_array_equal(a["seg_label"], b["seg_label"])
        assert len(a["img_data"]) == len(b["img_data"]) == 3
        for la, lb in zip(a["img_data"], b["img_data"]):
            assert la.dtype == lb.dtype == (np.uint8 if device_preprocess else np.float32)
            np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("canvas", [(64, 64), (90, 90), (1088, 1600)])
def test_val_dataset_device_pyramid_items_equal(val_set, canvas):
    """With ``device_pyramid_canvas`` an original that fits has an empty
    host pyramid, an oversized one keeps it; as in the JAX package."""
    root, odgt = val_set
    opt = _cfg(port_config, "DATASET.imgSizes", SIZES).DATASET
    kw = dict(device_preprocess=True, bucket_step=8, device_pyramid_canvas=canvas)
    port = port_data.ValDataset(root, odgt, opt, **kw)
    ref = jax_data.ValDataset(root, odgt, opt, **kw)
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        fits = SHAPES[i][0] <= canvas[0] and SHAPES[i][1] <= canvas[1]
        assert len(a["img_data"]) == len(b["img_data"]) == (0 if fits else 3)
        np.testing.assert_array_equal(a["img_ori"], b["img_ori"])
        np.testing.assert_array_equal(a["seg_label"], b["seg_label"])
        for la, lb in zip(a["img_data"], b["img_data"]):
            np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("device_preprocess,bucket_step", PYRAMID_MODES)
def test_test_dataset_pyramids_equal(val_set, device_preprocess, bucket_step):
    root, _ = val_set
    opt = _cfg(port_config, "DATASET.imgSizes", SIZES).DATASET
    records = [{"fpath_img": os.path.join(root, f"img{i}.{'png' if i == 0 else 'jpg'}")}
               for i in range(len(SHAPES))]
    kw = dict(device_preprocess=device_preprocess, bucket_step=bucket_step)
    port = port_data.TestDataset(records, opt, **kw)
    ref = jax_data.TestDataset(records, opt, **kw)
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        np.testing.assert_array_equal(a["img_ori"], b["img_ori"])
        for la, lb in zip(a["img_data"], b["img_data"]):
            assert la.dtype == lb.dtype
            np.testing.assert_array_equal(la, lb)


def test_eval_loader_keeps_order(val_set):
    root, odgt = val_set
    opt = _cfg(port_config, "DATASET.imgSizes", SIZES).DATASET
    ds = port_data.ValDataset(root, odgt, opt, device_preprocess=True, bucket_step=8)
    infos = [it["info"] for it in port_data.EvalLoader(ds, num_workers=3, prefetch=2)]
    assert infos == [r["fpath_img"] for r in ds.list_sample]


@pytest.mark.parametrize("n,seed", [(16, 0), (200, 3)])
def test_sample_odgt_shapes_agree(n, seed):
    """The serving smoke's (and a later bench's) request shapes."""
    odgt = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "data", "validation.odgt")
    got = port_dataset.sample_odgt_shapes(odgt, n, seed=seed)
    assert got == jax_dataset.sample_odgt_shapes(odgt, n, seed=seed)
    assert len(got) == n and all(h > 0 and w > 0 for h, w in got)


@pytest.mark.parametrize("padding_constant", [4, 8, 32])
def test_effective_lattice_agrees(padding_constant):
    for step in [None, 0, 1, 3, 7, 8, 9, 16, 24, 31, 32, 33, 48, 64, 100]:
        assert (port_dataset._effective_lattice(step, padding_constant)
                == jax_dataset._effective_lattice(step, padding_constant))


@pytest.mark.parametrize("num_class,void_share", [(150, 0.0), (150, 0.3), (7, 0.5)])
def test_metrics_agree(num_class, void_share):
    rng = np.random.RandomState(num_class + int(void_share * 10))
    inter = {"port": np.zeros(num_class), "jax": np.zeros(num_class)}
    union = {"port": np.zeros(num_class), "jax": np.zeros(num_class)}
    for h, w in SHAPES:
        pred = rng.randint(0, num_class, (h, w))
        # Labels as the datasets give them: uint8 255 (void) becomes -1.
        lab_u8 = rng.randint(1, num_class + 1, (h, w)).astype(np.uint8)
        lab_u8[rng.rand(h, w) < void_share] = 0
        label = lab_u8.astype(np.int32) - 1
        # About half the labelled pixels predicted right.
        pred = np.where((rng.rand(h, w) < 0.5) & (label >= 0), label, pred)
        for name, mod in (("port", port_utils), ("jax", jax_utils)):
            acc, pix = mod.accuracy(pred, label)
            i, u = mod.intersectionAndUnion(pred, label, num_class)
            inter[name] += i
            union[name] += u
        assert port_utils.accuracy(pred, label) == jax_utils.accuracy(pred, label)
    np.testing.assert_array_equal(inter["port"], inter["jax"])
    np.testing.assert_array_equal(union["port"], union["jax"])
    iou_p, miou_p = port_utils.miou_from_meters(inter["port"], union["port"])
    iou_j, miou_j = jax_utils.miou_from_meters(inter["jax"], union["jax"])
    np.testing.assert_array_equal(iou_p, iou_j)
    assert miou_p == miou_j


def test_average_meter_and_visual_helpers_agree():
    port, ref = port_utils.AverageMeter(), jax_utils.AverageMeter()
    for val, weight in [(0.5, 10), (0.25, 30), (1.0, 1)]:
        port.update(val, weight)
        ref.update(val, weight)
    assert (port.average(), port.sum, port.count) == (ref.average(), ref.sum, ref.count)
    labels = np.arange(-1, 151).reshape(8, 19)
    np.testing.assert_array_equal(port_utils.colorEncode(labels), jax_utils.colorEncode(labels))
    np.testing.assert_array_equal(port_utils.colorEncode(labels, mode="BGR"),
                                  jax_utils.colorEncode(labels, mode="BGR"))
    assert port_utils.load_class_names() == jax_utils.load_class_names()
    np.testing.assert_array_equal(port_utils.unique(labels), jax_utils.unique(labels))
