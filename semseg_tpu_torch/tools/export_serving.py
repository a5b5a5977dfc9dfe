"""Export a checkpoint as a serving bundle (``tools/export_serving.py``).

    python -m semseg_tpu_torch.tools.export_serving --cfg config/<cfg>.yaml --out bundle/ \
        [--shapes 448x608,512x683] [--batch 1] [--device cuda] \
        [DIR ckpt TEST.checkpoint epoch_20.pth ...]

The bundle (``semseg_tpu_torch/serving.py``) serves single-scale inference
with no model code on the serving host. Its programs run on the device type
they were exported on: the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description="export a semseg_tpu_torch serving bundle")
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--shapes", default="448x608", help="comma-separated HxW bucket list")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    from semseg_tpu_torch.checkpoint import resolve_reference_checkpoint
    from semseg_tpu_torch.config import cfg as _default_cfg

    cfg = _default_cfg.clone()
    cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    resolve_reference_checkpoint(cfg, cfg.TEST.checkpoint)

    shapes = []
    pad = cfg.DATASET.padding_constant
    for tok in args.shapes.split(","):
        h, w = (int(v) for v in tok.split("x"))
        if h % pad or w % pad:
            raise ValueError(f"shape {tok} must be a multiple of padding_constant {pad}")
        shapes.append((h, w))

    from semseg_tpu_torch.models import ModelBuilder
    from semseg_tpu_torch.serving import export_bundle

    model = ModelBuilder.build_model(cfg, device=args.device)
    tic = time.perf_counter()
    manifest = export_bundle(model, args.out, shapes=shapes, batch_size=args.batch,
                             num_class=cfg.DATASET.num_class)
    seconds = time.perf_counter() - tic
    sizes = {p["file"]: os.path.getsize(os.path.join(args.out, p["file"]))
             for p in manifest["programs"]}
    params = os.path.getsize(os.path.join(args.out, "params.pt"))
    print(f"exported {len(shapes)} program(s) + params to {args.out} on "
          f"{manifest['device']} in {seconds:.1f} s: "
          + ", ".join(f"{f} {n / 1e6:.2f} MB" for f, n in sizes.items())
          + f"; params.pt {params / 1e6:.1f} MB")
    return manifest


if __name__ == "__main__":
    main()
