"""The device-pyramid path through ``cli.eval`` and ``evaluate`` on the CPU.

* ``cli.eval --device-pyramid --device cpu`` builds the device-pyramid
  engine and counts the same labelled pixels as the default path; at
  ``--batch 0`` the flag is ignored;
* ``evaluate`` sends items without a host pyramid to
  ``batched_metrics_from_originals`` and oversized originals, which keep
  theirs, to ``batched_metrics``: the same pixel counts as the host path,
  pixel accuracy within 2% of the pixels (only the resize backend differs);
* the engine rejects an original larger than its canvas.
"""

import logging

import numpy as np
import pytest
import torch

from semseg_tpu_torch.cli import eval as eval_cli
from semseg_tpu_torch.config import cfg
from semseg_tpu_torch.data import EvalLoader, ValDataset
from semseg_tpu_torch.engine import BatchedInferenceEngine, DevicePyramidEngine
from semseg_tpu_torch.models import SegmentationModel
from semseg_tpu_torch.models.decoders import PPMDeepsup
from semseg_tpu_torch.models.resnet import ResNetEncoder

from test_torch_engine import CFG, SMALL, _val_set, reference_pth  # noqa: F401

C = 150
ENGINE = dict(num_class=C, output_stride=8, bucket_step=16, img_sizes=(64, 96),
              img_max_size=160, ori_step=32, ori_canvas=(160, 160))


def _narrow_port():
    """A narrow float32 resnet18dilated + ppm_deepsup, seeded."""
    torch.manual_seed(0)
    encoder = ResNetEncoder(block="basic", dilate_scale=8, layers=(1, 1, 1, 1),
                            planes=(8, 16, 32, 64))
    model = SegmentationModel(encoder, PPMDeepsup(num_class=C, fc_dim=64))
    return model.eval().to(memory_format=torch.channels_last)


def test_engine_rejects_an_oversized_original():
    eng = DevicePyramidEngine(None, device="cpu", **ENGINE)
    ori = np.zeros((161, 100, 3), np.uint8)
    with pytest.raises(ValueError, match="canvas"):
        eng.batched_metrics_from_originals([ori], [np.zeros((161, 100), np.int32)])
    assert eng.batched_metrics_from_originals([], []) == []


def test_oversized_originals_fall_back_to_host_pyramids(tmp_path):
    """``evaluate`` sends items without a host pyramid to the device path
    and the oversized ones (which keep theirs) to ``batched_metrics``."""
    port = _narrow_port()
    data = _val_set(tmp_path, [(113, 149), (170, 100), (128, 128), (90, 200)], seed=8)
    c = cfg.clone()
    c.merge_from_list(data + ["DATASET.imgSizes", "(64, 96)", "DATASET.imgMaxSize", "160",
                              "TPU.eval_bucket_step", "16"])
    eng = DevicePyramidEngine(port, device="cpu", batch_size=2, num_class=C, output_stride=8,
                              bucket_step=16, img_sizes=(64, 96), img_max_size=160,
                              ori_step=32, ori_canvas=(160, 160))
    calls = []
    for name in ("batched_metrics", "batched_metrics_from_originals"):
        real = getattr(eng, name)
        setattr(eng, name, lambda *a, _r=real, _n=name: calls.append((_n, len(a[0]))) or _r(*a))
    ds = ValDataset(c.DATASET.root_dataset, c.DATASET.list_val, c.DATASET,
                    device_preprocess=True, bucket_step=16, device_pyramid_canvas=eng.ori_canvas)
    assert [len(ds[i]["img_data"]) for i in range(4)] == [0, 2, 0, 2]
    log = logging.getLogger("test")
    *_, raw = eval_cli.evaluate([eng], EvalLoader(ds, num_workers=1), c, log)
    assert sorted(calls) == [("batched_metrics", 2), ("batched_metrics_from_originals", 2)]
    host = BatchedInferenceEngine(port, device="cpu", batch_size=2, num_class=C,
                                  output_stride=8, bucket_step=16)
    ref_ds = ValDataset(c.DATASET.root_dataset, c.DATASET.list_val, c.DATASET,
                        device_preprocess=True, bucket_step=16)
    *_, ref = eval_cli.evaluate([host], EvalLoader(ref_ds, num_workers=1), c, log)
    assert raw["pix_count"] == ref["pix_count"]
    assert abs(raw["acc_sum"] - ref["acc_sum"]) < 0.02 * ref["pix_count"]


def test_eval_cli_device_pyramid_runs(reference_pth, tmp_path, monkeypatch):  # noqa: F811
    """``--device-pyramid`` builds the device-pyramid engine and counts the
    same labelled pixels as the default path; it is ignored at --batch 0."""
    data = _val_set(tmp_path, [(48, 64), (56, 40), (48, 60), (41, 64)], seed=9)
    common = ["--cfg", CFG, "--device", "cpu", "--batch", "2"]
    built = []
    real = eval_cli.build_engines

    def spy(*a, **kw):
        built.append(real(*a, **kw)[0])
        return [built[-1]]

    monkeypatch.setattr(eval_cli, "build_engines", spy)
    runs = [eval_cli.main([*common, *flags, "DIR", str(reference_pth), *data, *SMALL])
            for flags in (["--device-pyramid"], [])]
    eval_cli.main(["--cfg", CFG, "--device", "cpu", "--batch", "0", "--device-pyramid",
                   "DIR", str(reference_pth), *data, *SMALL])
    assert [type(e).__name__ for e in built] == [
        "DevicePyramidEngine", "BatchedInferenceEngine", "InferenceEngine"]
    (miou, acc, iou, raw), (_, _, _, ref) = runs
    assert 0.0 <= miou <= 1.0 and 0.0 <= acc <= 1.0 and iou.shape == (C,)
    assert raw["pix_count"] == ref["pix_count"] > 0
