"""The port's per-image engines and CLIs on the CPU.

The exact engine is held against the JAX package's
``InferenceEngine(exact=True)`` and the bucketed per-image engine against
``InferenceEngine(exact=False)`` (float32 fetch, no denylist), on 2-scale
pyramids through a narrow float32 model, within atol 1e-4 on the averaged
probabilities. The CLIs run end to end on the CPU (``--device cpu``) with a
random reference-format ``.pth`` pair.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from semseg_tpu.engine import InferenceEngine as JaxInferenceEngine

from semseg_tpu_torch.cli import eval as eval_cli, test as test_cli
from semseg_tpu_torch.engine import InferenceEngine
from semseg_tpu_torch.models import ModelBuilder
from semseg_tpu_torch.models.convert import SYNCBN_ACCUMULATORS

from test_torch_model import narrow_jax_model, narrow_port_model

CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "config", "ade20k-resnet50dilated-ppm_deepsup.yaml")
# Small pyramid so the full-width model runs quickly on the CPU.
SMALL = ["DATASET.imgSizes", "(40, 56)", "DATASET.imgMaxSize", "80"]


def _pyramid(rng):
    return [rng.randn(1, 40, 56, 3).astype(np.float32),
            rng.randint(0, 256, (1, 48, 64, 3)).astype(np.uint8)]


def test_exact_engine_matches_jax():
    jax_model, variables = narrow_jax_model()
    pyramid = _pyramid(np.random.RandomState(3))
    seg_size = (45, 61)
    ref_engine = JaxInferenceEngine(jax_model, variables, exact=True, bucket_denylist=())
    ref = ref_engine.scores_for_pyramid(pyramid, seg_size)

    engine = InferenceEngine(narrow_port_model(variables), device="cpu")
    scores = engine.scores_for_pyramid(pyramid, seg_size)
    assert scores.shape == (*seg_size, 150) and scores.dtype == np.float32
    np.testing.assert_allclose(scores, ref, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(engine.predict(pyramid, seg_size), ref.argmax(-1))


def test_bucketed_engine_matches_jax():
    """Levels off the step-8 lattice are padded to their bucket, so the
    valid-region mask and the pad-aware pools do real work."""
    jax_model, variables = narrow_jax_model()
    rng = np.random.RandomState(7)
    pyramid = [rng.randint(0, 256, (1, 45, 61, 3)).astype(np.uint8),
               rng.randint(0, 256, (1, 64, 80, 3)).astype(np.uint8),
               rng.randint(0, 256, (1, 37, 50, 3)).astype(np.uint8)]
    seg_size = (47, 63)
    ref_engine = JaxInferenceEngine(jax_model, variables, exact=False, bucket_step=8,
                                    bucket_denylist=(), fetch_dtype=None)
    ref = ref_engine.scores_for_pyramid(pyramid, seg_size)

    engine = InferenceEngine(narrow_port_model(variables), device="cpu", exact=False,
                             bucket_step=8)
    scores = engine.scores_for_pyramid(pyramid, seg_size)
    assert scores.shape == (*seg_size, 150) and scores.dtype == np.float32
    np.testing.assert_allclose(scores, ref, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(engine.predict(pyramid, seg_size), ref.argmax(-1))


def test_bucketed_engine_takes_uint8_levels_only():
    engine = InferenceEngine(None, device="cpu", exact=False, bucket_step=8)
    with pytest.raises(TypeError, match="uint8"):
        engine.predict([np.zeros((1, 40, 56, 3), np.float32)], (40, 56))


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    """A seeded full-width model saved as a reference-format .pth pair."""
    from semseg_tpu.config import cfg

    ckpt = tmp_path_factory.mktemp("ckpt")
    model = ModelBuilder.build_model(cfg.clone(), device="cpu", seed=5)
    for name, module in (("encoder", model.encoder), ("decoder", model.decoder)):
        sd = module.state_dict()
        # The reference SyncBN also saves its accumulators.
        for key in [k for k in sd if k.endswith(".running_mean")]:
            prefix = key[: -len("running_mean")]
            for acc in SYNCBN_ACCUMULATORS:
                sd[prefix + acc] = torch.ones(1)
        torch.save(sd, ckpt / f"{name}_epoch_20.pth")
    return ckpt


def test_test_cli_writes_png(reference_pth, tmp_path):
    img_path = tmp_path / "street.jpg"
    rng = np.random.RandomState(4)
    Image.fromarray(rng.randint(0, 256, (48, 64, 3), np.uint8)).save(img_path)
    out_dir = tmp_path / "out"
    test_cli.main(["--imgs", str(img_path), "--cfg", CFG, "--device", "cpu",
                   "DIR", str(reference_pth), "TEST.result", str(out_dir), *SMALL])
    png = np.asarray(Image.open(out_dir / "street.png"))
    assert png.shape == (48, 128, 3)


@pytest.mark.parametrize("exact", [False, True], ids=["default", "exact"])
def test_test_cli_runs_the_jax_clis_engine(reference_pth, tmp_path, monkeypatch, exact):
    """With no flags the test CLI runs the bucketed per-image engine over
    uint8 levels on the step-8 lattice (as ``semseg_tpu/cli/test.py``
    does); with ``--exact`` the exact engine. Each writes its engine's map."""
    from semseg_tpu.config import cfg
    from semseg_tpu.data import TestDataset
    from semseg_tpu.utils import colorEncode

    img_path = tmp_path / "room.jpg"
    Image.fromarray(np.random.RandomState(8).randint(0, 256, (45, 61, 3), np.uint8)).save(img_path)
    built = []
    real_build = eval_cli.build_engines

    def spy(*args, **kw):
        engines = real_build(*args, **kw)
        built.extend(engines)
        return engines

    monkeypatch.setattr(test_cli, "build_engines", spy)
    out_dir = tmp_path / "out"
    test_cli.main(["--imgs", str(img_path), "--cfg", CFG, "--device", "cpu",
                   *(["--exact"] if exact else []),
                   "DIR", str(reference_pth), "TEST.result", str(out_dir), *SMALL])
    (engine,) = built
    assert engine.exact == exact and engine.fetch_dtype == torch.float32

    c = cfg.clone()
    c.merge_from_file(CFG)
    c.merge_from_list(SMALL)
    item = TestDataset([{"fpath_img": str(img_path)}], c.DATASET, device_preprocess=not exact,
                       bucket_step=None if exact else c.TPU.eval_bucket_step)[0]
    assert all(lvl.dtype == (np.float32 if exact else np.uint8) for lvl in item["img_data"])
    pred = engine.predict(item["img_data"], (45, 61))
    png = np.asarray(Image.open(out_dir / "room.png"))
    np.testing.assert_array_equal(png[:, 61:], colorEncode(pred, mode="RGB").astype(np.uint8))


def _val_set(root, shapes, seed):
    rng = np.random.RandomState(seed)
    records = []
    for i, (h, w) in enumerate(shapes):
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(root / f"{i}.jpg")
        Image.fromarray(rng.randint(0, 151, (h, w), np.uint8), mode="L").save(root / f"{i}.png")
        records.append({"fpath_img": f"{i}.jpg", "fpath_segm": f"{i}.png",
                        "height": h, "width": w})
    odgt = root / "val.odgt"
    odgt.write_text("".join(json.dumps(r) + "\n" for r in records))
    return ["DATASET.root_dataset", str(root), "DATASET.list_val", str(odgt)]


def test_eval_cli_exact(reference_pth, tmp_path):
    data = _val_set(tmp_path, [(48, 64), (56, 40)], seed=5)
    miou, acc, iou, raw = eval_cli.main([
        "--cfg", CFG, "--exact", "--device", "cpu", "DIR", str(reference_pth), *data, *SMALL,
    ])
    assert 0.0 <= miou <= 1.0 and 0.0 <= acc <= 1.0 and iou.shape == (150,)
    assert raw["pix_count"] > 0
