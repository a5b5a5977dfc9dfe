"""Evaluation CLI (``semseg_tpu/cli/eval.py``), one device.

Multi-scale evaluation over a val odgt with mIoU and pixel accuracy. By
default the batched engine runs the protocol the JAX CLI ships: uint8
levels resized onto the step lattice (``TPU.eval_bucket_step``), batches of
4 same-bucket levels with under-filled buckets packed, pad-aware pooling,
and metrics computed on the device over chunks of 32 images. ``--batch
0``/``1`` runs the bucketed per-image engine, ``--exact`` the reference
computation over host float pyramids.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from semseg_tpu.config import cfg as _default_cfg
from semseg_tpu.data import EvalLoader, ValDataset
from semseg_tpu.data.dataset import _effective_lattice
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
from semseg_tpu_torch.engine import (
    BatchedInferenceEngine,
    InferenceEngine,
    output_stride_for,
)
from semseg_tpu_torch.models import ModelBuilder

CHUNK = 32  # images per batched-engine call


def visualize_result(item, pred, save_dir):
    from PIL import Image

    seg_color = colorEncode(item["seg_label"][0], mode="RGB")
    pred_color = colorEncode(pred, mode="RGB")
    im_vis = np.concatenate((item["img_ori"], seg_color, pred_color), axis=1)
    os.makedirs(save_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(item["info"]))[0] + ".png"
    Image.fromarray(im_vis.astype(np.uint8)).save(os.path.join(save_dir, name))


def build_engines(cfg, num_devices=1, exact=False, batch=0, fetch_dtype=None,
                  pack_buckets=False, *, device="cuda"):
    """The engine over the model that ``cfg`` names, on ``device``, as a
    one-element list (the JAX CLI's shape): the exact engine with
    ``exact``, the batched engine for ``batch > 1``, else the bucketed
    per-image engine."""
    if num_devices != 1:
        raise NotImplementedError("the port evaluates on one device (multi-GPU: ROADMAP item 11)")
    model = ModelBuilder.build_model(cfg, device=device)
    kw = dict(
        num_class=cfg.DATASET.num_class,
        device=device,
        exact=exact,
        output_stride=output_stride_for(cfg),
        # The engine's grouping lattice must equal the dataset's resize
        # lattice, both aligned to the architecture's padding_constant.
        bucket_step=_effective_lattice(cfg.TPU.eval_bucket_step, cfg.DATASET.padding_constant),
        padding_constant=cfg.DATASET.padding_constant,
        fetch_dtype=fetch_dtype,
    )
    if batch > 1 and not exact:
        return [BatchedInferenceEngine(model, batch_size=batch,
                                       pack_buckets=pack_buckets, **kw)]
    return [InferenceEngine(model, **kw)]


def _chunks(loader, size):
    chunk = []
    for item in loader:
        chunk.append(item)
        if len(chunk) == size:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


def evaluate(engines, loader, cfg, logger, visualize=False, vis_dir=None):
    """Run the engine over ``loader``; returns (mIoU, accuracy, IoU, raw sums)."""
    (engine,) = engines
    num_class = cfg.DATASET.num_class
    acc_meter = AverageMeter()
    time_meter = AverageMeter()
    inter_sum = np.zeros(num_class, np.float64)
    union_sum = np.zeros(num_class, np.float64)

    def score_one(item, pred):
        nonlocal inter_sum, union_sum
        seg_label = np.asarray(item["seg_label"][0])
        acc, pix = accuracy(pred, seg_label)
        inter, union = intersectionAndUnion(pred, seg_label, num_class)
        acc_meter.update(acc, pix)
        inter_sum += inter
        union_sum += union
        if visualize:
            visualize_result(item, pred, vis_dir)

    if isinstance(engine, BatchedInferenceEngine):
        for chunk in _chunks(loader, CHUNK):
            labels = [np.asarray(it["seg_label"][0]) for it in chunk]
            tic = time.perf_counter()
            if not visualize:
                # Only the packed metric vectors leave the device.
                metrics = engine.batched_metrics([it["img_data"] for it in chunk], labels)
                elapsed = (time.perf_counter() - tic) / len(chunk)
                for acc_sum, pix_sum, inter, union in metrics:
                    acc_meter.update(float(acc_sum) / (float(pix_sum) + 1e-10), int(pix_sum))
                    inter_sum += inter.astype(np.float64)
                    union_sum += union.astype(np.float64)
                    time_meter.update(elapsed)
            else:
                # Visualization needs the prediction maps on the host.
                preds = engine.batched_predict([it["img_data"] for it in chunk],
                                               [lab.shape for lab in labels])
                elapsed = (time.perf_counter() - tic) / len(chunk)
                for item, pred in zip(chunk, preds):
                    time_meter.update(elapsed)
                    score_one(item, pred)
    else:
        for item in loader:
            seg_label = np.asarray(item["seg_label"][0])
            tic = time.perf_counter()
            pred = engine.predict(item["img_data"], seg_label.shape)
            time_meter.update(time.perf_counter() - tic)
            score_one(item, pred)

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
        # Shard-combinable sums: global metrics are f(sum over shards).
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
                        help="per-image reference computation (no bucketing)")
    parser.add_argument("--batch", type=int, default=4,
                        help="cross-image bucket batch size (0/1 = per-image)")
    parser.add_argument("--fetch-dtype", default="bfloat16",
                        help="dtype the logits are rounded to before host "
                             "post-processing (float32 for exact parity)")
    parser.add_argument("--bucket-step", type=int, default=0,
                        help="override TPU.eval_bucket_step (8 = the "
                             "reference protocol's lattice, the default)")
    parser.add_argument("--pack-buckets", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="fold under-filled bucket batches into larger "
                             "buckets (area ratio <= 1.3, <= 32 px pad per "
                             "dimension); --no-pack-buckets keeps one bucket "
                             "per lattice point")
    parser.add_argument("--start-idx", type=int, default=-1,
                        help="val-list shard start")
    parser.add_argument("--end-idx", type=int, default=-1,
                        help="val-list shard end (exclusive; omit for 'to the end')")
    parser.add_argument("--metrics-out", default="",
                        help="write raw combinable metric sums (acc_sum, "
                             "pix_count, per-class inter/union) to this .npz")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)
    # parse_odgt slices only when both indices are >= 0.
    if (args.start_idx >= 0) != (args.end_idx >= 0):
        if args.start_idx >= 0:
            args.end_idx = 1 << 31
        else:
            args.start_idx = 0

    cfg = _default_cfg.clone()
    cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if args.bucket_step:
        cfg.TPU.eval_bucket_step = args.bucket_step
    resolve_reference_checkpoint(cfg, cfg.VAL.checkpoint)

    logger = setup_logger()
    engines = build_engines(
        cfg, 1, exact=args.exact, batch=args.batch,
        fetch_dtype=None if args.exact else args.fetch_dtype,
        pack_buckets=args.pack_buckets, device=args.device,
    )
    dataset = ValDataset(
        cfg.DATASET.root_dataset, cfg.DATASET.list_val, cfg.DATASET,
        device_preprocess=not args.exact,
        # Bucket by resize: levels land on the lattice, so the engine
        # pads only what packing folds into a larger bucket.
        bucket_step=None if args.exact else cfg.TPU.eval_bucket_step,
        start_idx=args.start_idx, end_idx=args.end_idx,
    )
    batched = isinstance(engines[0], BatchedInferenceEngine)
    loader = EvalLoader(dataset, num_workers=5, prefetch=CHUNK if batched else 16)
    result = evaluate(
        engines, loader, cfg, logger, visualize=cfg.VAL.visualize,
        vis_dir=os.path.join(cfg.DIR, "result"),
    )
    if args.metrics_out:
        raw = {k: v for k, v in result[3].items() if k != "seconds_per_image"}
        np.savez(args.metrics_out, **raw)
        logger.info(f"Wrote raw metric sums to {args.metrics_out}")
    logger.info("Evaluation Done!")
    return result


if __name__ == "__main__":
    main()
