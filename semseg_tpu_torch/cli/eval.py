"""Evaluation CLI (``semseg_tpu/cli/eval.py``), exact mode.

Multi-scale evaluation over a val odgt with mIoU and pixel accuracy, through
the exact per-image engine. The batched engines (the JAX CLI's default
without ``--exact``) are not ported yet, so ``--exact`` is required.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from semseg_tpu.config import cfg as _default_cfg
from semseg_tpu.data import EvalLoader, ValDataset
from semseg_tpu.utils import (
    AverageMeter,
    accuracy,
    colorEncode,
    intersectionAndUnion,
    load_class_names,
    setup_logger,
)
from semseg_tpu.utils.metrics import miou_from_meters

from semseg_tpu_torch.checkpoint import resolve_reference_checkpoint
from semseg_tpu_torch.engine import InferenceEngine
from semseg_tpu_torch.models import ModelBuilder


def visualize_result(item, pred, save_dir):
    from PIL import Image

    seg_color = colorEncode(item["seg_label"][0], mode="RGB")
    pred_color = colorEncode(pred, mode="RGB")
    im_vis = np.concatenate((item["img_ori"], seg_color, pred_color), axis=1)
    os.makedirs(save_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(item["info"]))[0] + ".png"
    Image.fromarray(im_vis.astype(np.uint8)).save(os.path.join(save_dir, name))


def build_engine(cfg, device) -> InferenceEngine:
    """The exact engine over the model that ``cfg`` names, on ``device``."""
    model = ModelBuilder.build_model(cfg, device=device)
    return InferenceEngine(model, num_class=cfg.DATASET.num_class, device=device)


def evaluate(engine, loader, cfg, logger, visualize=False, vis_dir=None):
    """Run ``engine`` over ``loader``; returns (mIoU, accuracy, IoU, raw sums)."""
    acc_meter = AverageMeter()
    time_meter = AverageMeter()
    inter_sum = np.zeros(cfg.DATASET.num_class, np.float64)
    union_sum = np.zeros(cfg.DATASET.num_class, np.float64)
    for item in loader:
        seg_label = np.asarray(item["seg_label"][0])
        tic = time.perf_counter()
        pred = engine.predict(item["img_data"], seg_label.shape)
        time_meter.update(time.perf_counter() - tic)
        acc, pix = accuracy(pred, seg_label)
        inter, union = intersectionAndUnion(pred, seg_label, cfg.DATASET.num_class)
        acc_meter.update(acc, pix)
        inter_sum += inter
        union_sum += union
        if visualize:
            visualize_result(item, pred, vis_dir)

    iou, miou = miou_from_meters(inter_sum, union_sum)
    names = load_class_names()
    for i, class_iou in enumerate(iou):
        logger.info(f"class [{i}], IoU: {class_iou:.4f}  ({names.get(i + 1, '?')})")
    logger.info(
        f"[Eval Summary]:\nMean IoU: {miou:.4f}, "
        f"Accuracy: {acc_meter.average() * 100:.2f}%, "
        f"Inference Time: {time_meter.average():.4f}s"
    )
    raw = {
        "acc_sum": float(acc_meter.sum or 0.0),
        "pix_count": float(acc_meter.count or 0.0),
        "inter": inter_sum,
        "union": union_sum,
        "seconds_per_image": time_meter.average(),
    }
    return miou, acc_meter.average(), iou, raw


def main(argv=None):
    parser = argparse.ArgumentParser(description="semseg_tpu_torch evaluation")
    parser.add_argument("--cfg", default="config/ade20k-resnet50dilated-ppm_deepsup.yaml")
    parser.add_argument("--gpu", default=None, help="reference CLI parity")
    parser.add_argument("--exact", action="store_true",
                        help="per-image reference computation (required: the "
                             "batched engines are not ported yet)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)
    if not args.exact:
        raise NotImplementedError(
            "only --exact is ported; the batched engine is ROADMAP item 5"
        )

    cfg = _default_cfg.clone()
    cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    resolve_reference_checkpoint(cfg, cfg.VAL.checkpoint)

    logger = setup_logger()
    engine = build_engine(cfg, args.device)
    dataset = ValDataset(
        cfg.DATASET.root_dataset, cfg.DATASET.list_val, cfg.DATASET,
        device_preprocess=False, bucket_step=None,
    )
    loader = EvalLoader(dataset, num_workers=2, prefetch=4)
    result = evaluate(
        engine, loader, cfg, logger, visualize=cfg.VAL.visualize,
        vis_dir=os.path.join(cfg.DIR, "result"),
    )
    logger.info("Evaluation Done!")
    return result


if __name__ == "__main__":
    main()
