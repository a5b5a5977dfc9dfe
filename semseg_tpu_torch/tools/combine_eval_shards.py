"""Combine per-shard eval metrics into global mIoU and accuracy (the port's
copy of ``tools/combine_eval_shards.py``).

Each host evaluates a slice of the val list (``cli.eval --start-idx
--end-idx --metrics-out shard.npz``). Per-class IoU ratios do not combine,
but the raw sums do:

    python -m semseg_tpu_torch.tools.combine_eval_shards shard0.npz shard1.npz ...

prints the global per-class IoU, mean IoU and pixel accuracy, as one run
over the union of the slices gives them.
"""

from __future__ import annotations

import argparse

import numpy as np

from semseg_tpu_torch.utils.metrics import miou_from_meters


def combine(paths):
    """(per-class IoU, mean IoU, pixel accuracy) over the shards' sums."""
    acc_sum = pix = 0.0
    inter = union = None
    for path in paths:
        z = np.load(path)
        acc_sum += float(z["acc_sum"])
        pix += float(z["pix_count"])
        inter = z["inter"] if inter is None else inter + z["inter"]
        union = z["union"] if union is None else union + z["union"]
    iou, miou = miou_from_meters(inter, union)
    return iou, miou, acc_sum / (pix + 1e-10)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("shards", nargs="+", help=".npz files from --metrics-out")
    args = parser.parse_args(argv)
    iou, miou, acc = combine(args.shards)
    for i, v in enumerate(iou):
        print(f"class [{i}], IoU: {v:.4f}")
    print(f"[Combined over {len(args.shards)} shard(s)]:\n"
          f"Mean IoU: {miou:.4f}, Accuracy: {100 * acc:.2f}%")
    return iou, miou, acc


if __name__ == "__main__":
    main()
