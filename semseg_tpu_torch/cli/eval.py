"""Evaluation CLI (``semseg_tpu/cli/eval.py``), on one device or several.

Multi-scale evaluation over a val odgt with mIoU and pixel accuracy. By
default the batched engine runs the protocol the JAX CLI ships: uint8
levels resized onto the step lattice (``TPU.eval_bucket_step``), batches of
4 same-bucket levels with under-filled buckets packed, pad-aware pooling,
and metrics computed on the device over chunks of 32 images. ``--batch
0``/``1`` runs the bucketed per-image engine, ``--exact`` the reference
computation over host float pyramids. ``--device-pyramid`` (batched only,
no ``--exact``, no ``VAL.visualize``) uploads each original once and
derives its levels on the device; originals larger than the engine's
canvas fall back to host pyramids.

``--devices N`` builds one engine per card (the first N visible; with
``--device cpu``, N engines on the CPU), and the engines take chunks of the
val set in turn, one thread each, as the JAX CLI does
(``cli/eval_multipro.py`` defaults to every visible card). Several hosts
each evaluate a slice (``--start-idx/--end-idx --metrics-out``) and
``tools/combine_eval_shards.py`` sums the slices.

``--spatial N`` > 1 is the JAX CLI's single-image latency mode: one
bucketed per-image engine splits each level's height across N devices
(``engine.InferenceEngine(spatial_devices=...)``): with a bare ``cuda``
the first N visible cards, with ``cuda:0`` or ``cpu`` N bands on that one
device. ``--devices`` is then ignored, and so are ``--batch`` and
``--device-pyramid``, with a warning when passed; ``--exact`` runs unsplit
on the first device, as the JAX CLI's does. ``TPU.spatial`` is not read
here, as in JAX (the trainer reads it).

``--profile DIR`` writes a ``torch.profiler`` trace of the eval loop (CPU
and CUDA activities) to ``DIR/eval_trace.json`` (Chrome trace format),
stopped once whether the loop ends or raises. The engines run in threads
of their own, so the trace holds their kernels but not their CPU-side
operators.
"""

from __future__ import annotations

import argparse
import os
import threading
import time

import numpy as np
import torch

from semseg_tpu_torch.checkpoint import resolve_reference_checkpoint
from semseg_tpu_torch.config import cfg as _default_cfg
from semseg_tpu_torch.data import EvalLoader, ValDataset
from semseg_tpu_torch.data.dataset import _effective_lattice
from semseg_tpu_torch.engine import (
    BatchedInferenceEngine,
    DevicePyramidEngine,
    InferenceEngine,
    output_stride_for,
)
from semseg_tpu_torch.models import ModelBuilder
from semseg_tpu_torch.parallel.distributed import visible_cards
from semseg_tpu_torch.utils import (
    AverageMeter,
    accuracy,
    colorEncode,
    intersectionAndUnion,
    load_class_names,
    miou_from_meters,
    setup_logger,
)

CHUNK = 32  # images per batched-engine call


def visualize_result(item, pred, save_dir):
    from PIL import Image

    seg_color = colorEncode(item["seg_label"][0], mode="RGB")
    pred_color = colorEncode(pred, mode="RGB")
    im_vis = np.concatenate((item["img_ori"], seg_color, pred_color), axis=1)
    os.makedirs(save_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(item["info"]))[0] + ".png"
    Image.fromarray(im_vis.astype(np.uint8)).save(os.path.join(save_dir, name))


def engine_devices(device, count: int = 1):
    """The devices of ``count`` engines: for a bare ``cuda`` the first
    ``min(count, visible)`` cards (the JAX package's ``make_mesh``), else
    ``count`` times ``device``."""
    d = torch.device(device)
    if count <= 1 or d.type != "cuda" or d.index is not None:
        return [device] * max(count, 1)
    return [torch.device("cuda", i) for i in range(visible_cards(count))]


def build_engines(cfg, num_devices=1, exact=False, batch=0, fetch_dtype=None,
                  pack_buckets=False, *, device_pyramid=False, device="cuda", devices=None,
                  spatial=0):
    """One engine over the model that ``cfg`` names per device of
    ``devices`` (default ``engine_devices(device, num_devices)``; a device
    may repeat): the exact engine with ``exact``; for ``batch > 1`` the
    device-pyramid engine with ``device_pyramid``, else the batched engine;
    otherwise the bucketed per-image engine. With ``spatial`` > 1, one
    per-image engine whose levels are split by height across
    ``engine_devices(device, spatial)`` (``batch``, ``device_pyramid`` and
    the device count unused), as ``semseg_tpu/cli/eval.py:249-275`` builds
    one over ``make_mesh(spatial)``."""
    if spatial > 1:
        devices = engine_devices(device, spatial)
        return [InferenceEngine(ModelBuilder.build_model(cfg, device=devices[0]),
                                spatial_devices=devices,
                                **_engine_kw(cfg, devices[0], exact, fetch_dtype))]
    if devices is None:
        devices = engine_devices(device, num_devices)
    engines = []
    for dev in devices:
        model = ModelBuilder.build_model(cfg, device=dev)
        kw = _engine_kw(cfg, dev, exact, fetch_dtype)
        if batch > 1 and not exact and device_pyramid:
            engines.append(DevicePyramidEngine(
                model, batch_size=batch, pack_buckets=pack_buckets,
                img_sizes=cfg.DATASET.imgSizes, img_max_size=cfg.DATASET.imgMaxSize, **kw))
        elif batch > 1 and not exact:
            engines.append(BatchedInferenceEngine(model, batch_size=batch,
                                                  pack_buckets=pack_buckets, **kw))
        else:
            engines.append(InferenceEngine(model, **kw))
    return engines


def _engine_kw(cfg, device, exact, fetch_dtype):
    """The engine settings ``cfg`` and the CLI give every engine."""
    return dict(
        num_class=cfg.DATASET.num_class,
        device=device,
        exact=exact,
        output_stride=output_stride_for(cfg),
        # The engine's grouping lattice must equal the dataset's resize
        # lattice, both aligned to the architecture's padding_constant.
        bucket_step=_effective_lattice(cfg.TPU.eval_bucket_step,
                                       cfg.DATASET.padding_constant),
        padding_constant=cfg.DATASET.padding_constant,
        fetch_dtype=fetch_dtype,
    )


def evaluate(engines, loader, cfg, logger, visualize=False, vis_dir=None):
    """Run the engines over ``loader``; returns (mIoU, accuracy, IoU, raw sums).

    One thread per engine takes the next chunk of the loader's items
    (``CHUNK`` images for a batched engine, one for a per-image engine)
    from a shared iterator until it runs dry; the metric sums are added
    under a lock, and the first error of any thread is raised here.
    """
    num_class = cfg.DATASET.num_class
    acc_meter = AverageMeter()
    time_meter = AverageMeter()
    inter_sum = np.zeros(num_class, np.float64)
    union_sum = np.zeros(num_class, np.float64)
    lock = threading.Lock()
    items = iter(loader)
    items_lock = threading.Lock()

    def next_chunk(size):
        out = []
        with items_lock:
            for item in items:
                out.append(item)
                if len(out) == size:
                    break
        return out

    def add(acc, pix, inter, union, seconds):
        nonlocal inter_sum, union_sum
        with lock:
            acc_meter.update(acc, pix)
            inter_sum += inter
            union_sum += union
            time_meter.update(seconds)

    def score_one(item, pred, seconds):
        seg_label = np.asarray(item["seg_label"][0])
        acc, pix = accuracy(pred, seg_label)
        inter, union = intersectionAndUnion(pred, seg_label, num_class)
        add(acc, pix, inter, union, seconds)
        if visualize:
            visualize_result(item, pred, vis_dir)

    def run_batched(engine, chunk):
        labels = [np.asarray(it["seg_label"][0]) for it in chunk]
        tic = time.perf_counter()
        if visualize:
            # Visualization needs the prediction maps on the host.
            preds = engine.batched_predict([it["img_data"] for it in chunk],
                                           [lab.shape for lab in labels])
            elapsed = (time.perf_counter() - tic) / len(chunk)
            for item, pred in zip(chunk, preds):
                score_one(item, pred, elapsed)
            return
        # Only the packed metric vectors leave the device. Items with an
        # empty host pyramid take the device-pyramid path; oversized
        # originals keep their host pyramids.
        dp = [k for k, it in enumerate(chunk) if not it["img_data"]]
        host = [k for k, it in enumerate(chunk) if it["img_data"]]
        metrics = [None] * len(chunk)
        if dp:
            out = engine.batched_metrics_from_originals(
                [chunk[k]["img_ori"] for k in dp], [labels[k] for k in dp])
            for k, m in zip(dp, out):
                metrics[k] = m
        if host:
            out = engine.batched_metrics([chunk[k]["img_data"] for k in host],
                                         [labels[k] for k in host])
            for k, m in zip(host, out):
                metrics[k] = m
        elapsed = (time.perf_counter() - tic) / len(chunk)
        for acc_sum, pix_sum, inter, union in metrics:
            add(float(acc_sum) / (float(pix_sum) + 1e-10), int(pix_sum),
                inter.astype(np.float64), union.astype(np.float64), elapsed)

    def run_engine(engine):
        if engine.device.type == "cuda" and engine.device.index is not None:
            torch.cuda.set_device(engine.device)  # this thread's current card
        batched = isinstance(engine, BatchedInferenceEngine)
        while True:
            work = next_chunk(CHUNK if batched else 1)
            if not work:
                return
            if batched:
                run_batched(engine, work)
            else:
                item = work[0]
                seg_label = np.asarray(item["seg_label"][0])
                tic = time.perf_counter()
                pred = engine.predict(item["img_data"], seg_label.shape)
                score_one(item, pred, time.perf_counter() - tic)

    errors = []

    def guarded(engine):
        try:
            run_engine(engine)
        except Exception as e:  # re-raised by the caller below
            errors.append(e)

    threads = [threading.Thread(target=guarded, args=(e,), name=f"eval-engine-{i}")
               for i, e in enumerate(engines)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]

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


def make_loader(cfg, engines, *, exact=False, device_pyramid=False, start_idx=-1, end_idx=-1):
    """The val set's loader as the engines take it."""
    dataset = ValDataset(
        cfg.DATASET.root_dataset, cfg.DATASET.list_val, cfg.DATASET,
        device_preprocess=not exact,
        # Bucket by resize: levels land on the lattice, so the engine
        # pads only what packing folds into a larger bucket.
        bucket_step=None if exact else cfg.TPU.eval_bucket_step,
        device_pyramid_canvas=engines[0].ori_canvas if device_pyramid else None,
        start_idx=start_idx, end_idx=end_idx,
    )
    batched = isinstance(engines[0], BatchedInferenceEngine)
    return EvalLoader(dataset, num_workers=5, prefetch=CHUNK * len(engines) if batched else 16)


def main(argv=None):
    parser = argparse.ArgumentParser(description="semseg_tpu_torch evaluation")
    parser.add_argument("--cfg", default="config/ade20k-resnet50dilated-ppm_deepsup.yaml")
    parser.add_argument("--devices", type=int, default=1,
                        help="eval devices: one engine per card (the first N visible; "
                             "with --device cpu, N engines on the CPU)")
    parser.add_argument("--gpu", default=None, help="reference CLI parity")
    parser.add_argument("--exact", action="store_true",
                        help="per-image reference computation (no bucketing)")
    parser.add_argument("--batch", type=int, default=None,
                        help="cross-image bucket batch size (0/1 = per-image; default 4)")
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
    parser.add_argument("--device-pyramid", action="store_true",
                        help="upload each original once and derive every "
                             "pyramid level on the device (Pillow's "
                             "antialiased bilinear filter); needs --batch > "
                             "1, no --exact and VAL.visualize False")
    parser.add_argument("--start-idx", type=int, default=-1,
                        help="val-list shard start")
    parser.add_argument("--end-idx", type=int, default=-1,
                        help="val-list shard end (exclusive; omit for 'to the end')")
    parser.add_argument("--metrics-out", default="",
                        help="write raw combinable metric sums (acc_sum, "
                             "pix_count, per-class inter/union) to this .npz")
    parser.add_argument("--profile", default="",
                        help="write a torch.profiler trace of the eval loop (CPU and "
                             "CUDA activities, Chrome trace format) into this directory")
    parser.add_argument("--spatial", type=int, default=0,
                        help="single-image latency mode: one engine splits each level's "
                             "height across N devices (a bare cuda: the first N cards; "
                             "cuda:0 or cpu: N bands on it); --devices, --batch and "
                             "--device-pyramid are ignored")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)
    batch_explicit = args.batch is not None
    batch = args.batch if batch_explicit else 4
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
    # Visualization needs host pyramids (batched_predict), which the
    # device-pyramid mode leaves empty; --spatial builds a per-image engine.
    device_pyramid = (args.device_pyramid and batch > 1 and not args.exact
                      and not cfg.VAL.visualize and args.spatial <= 1)
    if args.device_pyramid and not device_pyramid and args.spatial <= 1:
        logger.warning("--device-pyramid ignored (requires --batch > 1, no --exact, "
                       "and VAL.visualize False)")
    if args.spatial > 1 and ((batch > 1 and batch_explicit) or args.device_pyramid):
        # Only for flags the user passed: --batch defaults to 4.
        logger.warning("--spatial is a single-image latency mode: --batch/--device-pyramid "
                       "are ignored")
    engines = build_engines(
        cfg, args.devices, exact=args.exact, batch=batch,
        fetch_dtype=None if args.exact else args.fetch_dtype,
        pack_buckets=args.pack_buckets, device_pyramid=device_pyramid, device=args.device,
        spatial=args.spatial,
    )
    if args.spatial > 1:
        logger.info("one engine, each level's height split across "
                    f"{', '.join(map(str, engines[0].spatial_devices))}")
    elif len(engines) > 1 or args.devices > 1:
        logger.info(f"{len(engines)} engine(s) on {', '.join(str(e.device) for e in engines)}")
    loader = make_loader(cfg, engines, exact=args.exact, device_pyramid=device_pyramid,
                         start_idx=args.start_idx, end_idx=args.end_idx)
    prof = None
    on_card = any(e.device.type == "cuda" for e in engines)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(args.profile, exist_ok=True)
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if on_card else []))
        prof.start()
    try:
        result = evaluate(
            engines, loader, cfg, logger, visualize=cfg.VAL.visualize,
            vis_dir=os.path.join(cfg.DIR, "result"),
        )
    finally:  # the trace is written whether the loop ends or raises
        if prof is not None:
            if on_card:
                torch.cuda.synchronize()
            prof.stop()
            prof.export_chrome_trace(os.path.join(args.profile, "eval_trace.json"))
            logger.info(f"Wrote a profiler trace of the eval loop to {args.profile}")
    if args.metrics_out:
        raw = {k: v for k, v in result[3].items() if k != "seconds_per_image"}
        np.savez(args.metrics_out, **raw)
        logger.info(f"Wrote raw metric sums to {args.metrics_out}")
    logger.info("Evaluation Done!")
    return result


if __name__ == "__main__":
    main()
