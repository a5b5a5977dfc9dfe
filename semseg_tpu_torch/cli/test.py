"""Inference CLI (``semseg_tpu/cli/test.py``).

Segments a file or a directory of .jpg images, logs each prediction's class
histogram (classes over 0.1% of pixels) and writes a side-by-side
[image | colorized prediction] PNG into ``cfg.TEST.result``. By default the
bucketed per-image engine runs over uint8 levels resized onto the step
lattice, as the JAX CLI does; ``--exact`` runs the reference computation.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from semseg_tpu_torch.checkpoint import resolve_reference_checkpoint
from semseg_tpu_torch.cli.eval import build_engines
from semseg_tpu_torch.config import cfg as _default_cfg
from semseg_tpu_torch.data import EvalLoader, TestDataset
from semseg_tpu_torch.utils import colorEncode, find_recursive, load_class_names, setup_logger


def visualize_result(item, pred, save_dir, logger):
    from PIL import Image

    names = load_class_names()
    uniques, counts = np.unique(pred, return_counts=True)
    logger.info(f"Predictions in [{item['info']}]:")
    for idx in np.argsort(counts)[::-1]:
        ratio = counts[idx] / pred.size * 100
        if ratio > 0.1:
            logger.info(f"  {names[int(uniques[idx]) + 1]}: {ratio:.2f}%")

    pred_color = colorEncode(pred, mode="RGB").astype(np.uint8)
    im_vis = np.concatenate((item["img_ori"], pred_color), axis=1)
    os.makedirs(save_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(item["info"]))[0] + ".png"
    Image.fromarray(im_vis).save(os.path.join(save_dir, name))


def main(argv=None):
    parser = argparse.ArgumentParser(description="semseg_tpu_torch inference")
    parser.add_argument("--imgs", required=True, help="image path or directory")
    parser.add_argument("--cfg", default="config/ade20k-resnet50dilated-ppm_deepsup.yaml")
    parser.add_argument("--gpu", default=None, help="reference CLI parity")
    parser.add_argument("--exact", action="store_true",
                        help="per-image reference computation (no bucketing)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)

    cfg = _default_cfg.clone()
    cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    resolve_reference_checkpoint(cfg, cfg.TEST.checkpoint)

    imgs = find_recursive(args.imgs) if os.path.isdir(args.imgs) else [args.imgs]
    if not imgs:
        raise FileNotFoundError(f"no .jpg images under {args.imgs}")

    logger = setup_logger()
    engine = build_engines(cfg, 1, exact=args.exact, device=args.device)[0]
    dataset = TestDataset(
        [{"fpath_img": x} for x in imgs], cfg.DATASET,
        device_preprocess=not args.exact,
        bucket_step=None if args.exact else cfg.TPU.eval_bucket_step,
    )
    for item in EvalLoader(dataset, num_workers=2, prefetch=4):
        pred = engine.predict(item["img_data"], item["img_ori"].shape[:2])
        visualize_result(item, pred, cfg.TEST.result, logger)
    logger.info("Inference done!")


if __name__ == "__main__":
    main()
