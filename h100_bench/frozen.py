"""Frozen copies of the program's shape rules and of its smoke's arithmetic.

The benchmark's traffic and its yardstick must not move when a later change
edits the program, so what it needs of the program's own rules is copied
here, each with its source. Nothing here imports the program.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (chip_smoke.py:279)
BF16_DENSE_FLOPS = 989e12  # H100 SXM, bf16 dense tensor-core peak
SCALES = (1, 2, 3, 6)
BINS = sum(s * s for s in SCALES)  # 50 pooled means per channel


def read_shapes(name) -> List[Tuple[int, int]]:
    """(height, width) rows of ``traffic/<name>``: the shapes of an odgt
    manifest of the repository, copied when the benchmark was defined; a
    list of (height, width) pairs is its own rows."""
    if isinstance(name, (list, tuple)):
        return [(int(h), int(w)) for h, w in name]
    with open(os.path.join(HERE, "traffic", name)) as f:
        return [(int(r["height"]), int(r["width"])) for r in csv.DictReader(f)]


def sample_odgt_shapes(shapes: Sequence[Tuple[int, int]], n: int, seed: int):
    """``n`` shapes drawn without replacement from a manifest's.
    From ``semseg_tpu_torch/data/dataset.py:116`` (``sample_odgt_shapes``),
    with an error when the manifest has fewer than ``n``."""
    if n > len(shapes):
        raise ValueError(f"{n} shapes asked of a manifest of {len(shapes)}")
    idx = np.random.RandomState(seed).choice(len(shapes), n, replace=False)
    return [tuple(shapes[i]) for i in idx]


# -- semseg_tpu_torch/data/transforms.py:45-57 ----------------------------------
def round_up(x, p):
    """Smallest multiple of ``p`` that is >= ``x`` (``round2nearest_multiple``)."""
    return ((x - 1) // p + 1) * p


def scale_for(height, width, short_size, max_size):
    """Short side to ``short_size``, the long side capped at ``max_size``."""
    return min(short_size / float(min(height, width)), max_size / float(max(height, width)))


# -- semseg_tpu_torch/data/dataset.py:59-66 -------------------------------------
def effective_lattice(bucket_step, padding_constant: int) -> int:
    """Smallest lattice >= bucket_step that keeps padding_constant alignment."""
    if not bucket_step:
        return padding_constant
    if bucket_step % padding_constant == 0:
        return bucket_step
    return ((bucket_step - 1) // padding_constant + 1) * padding_constant


# -- semseg_tpu_torch/data/dataset.py:229-239, 303-323 (TrainDataset) -----------
def aspect_bin(shape) -> int:
    """0 for portrait (h > w), 1 otherwise (``_get_sub_batch``)."""
    return 0 if shape[0] > shape[1] else 1


def train_canvas(shapes, short_size: int, max_size: int, lattice: int):
    """A training batch's sizes (``next_batch``): each image scaled by
    ``scale_for`` and truncated, the canvas at the batch maximum rounded up
    to ``lattice``. Returns ((canvas_h, canvas_w), [(h, w), ...])."""
    sizes = []
    for h, w in shapes:
        s = scale_for(h, w, short_size, max_size)
        sizes.append((int(h * s), int(w * s)))
    canvas = (int(round_up(max(h for h, _ in sizes), lattice)),
              int(round_up(max(w for _, w in sizes), lattice)))
    return canvas, sizes


# -- semseg_tpu_torch/engine.py:614-622 (DevicePyramidEngine.level_plan) --------
def level_plan(ori_h: int, ori_w: int, img_sizes, max_size, lattice: int):
    """Per scale, the level's (h, w) on the engine's lattice."""
    return [(round_up(int(ori_h * scale_for(ori_h, ori_w, s, max_size)), lattice),
             round_up(int(ori_w * scale_for(ori_h, ori_w, s, max_size)), lattice))
            for s in img_sizes]


# -- semseg_tpu_torch/engine.py:300-394, 627-641 (the batched engines' schedule) -
def pack_groups(groups: Dict, batch: int, max_area_ratio=1.3, max_pad_px=32):
    """Fold under-filled bucket groups into larger buckets
    (``BatchedInferenceEngine._pack_groups``), in place; returns ``groups``."""
    if len(groups) <= 1:
        return groups

    def cost(key, n):
        return -(-n // batch) * key[0] * key[1]

    for k in sorted(groups, key=lambda k: k[0] * k[1]):
        if k not in groups:
            continue
        n_k = len(groups[k])
        best, best_delta = None, 0
        for k2 in groups:
            if k2 == k or k2[0] < k[0] or k2[1] < k[1]:
                continue
            if k2[0] * k2[1] > max_area_ratio * k[0] * k[1]:
                continue
            if k2[0] - k[0] > max_pad_px or k2[1] - k[1] > max_pad_px:
                continue
            n2 = len(groups[k2])
            delta = cost(k2, n2 + n_k) - cost(k2, n2) - cost(k, n_k)
            if delta < best_delta:
                best, best_delta = k2, delta
        if best is not None:
            groups[best].extend(groups.pop(k))
    return groups


def canvas_windows(seg_sizes, lattice: int, num_class: int, batch: int,
                   budget_bytes: int = 4096 << 20):
    """The device-pyramid engine's windows of images (``_canvas_windows``
    cut to ``2 * batch`` items by ``DevicePyramidEngine._windows``)."""
    windows, cur, cur_bytes = [], [], 0
    for i, (h, w) in enumerate(seg_sizes):
        b = round_up(h, lattice) * round_up(w, lattice) * num_class * 4
        if cur and cur_bytes + b > budget_bytes:
            windows.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += b
    if cur:
        windows.append(cur)
    n = max(2 * batch, 1)
    return [w[lo:lo + n] for w in windows for lo in range(0, len(w), n)]


def eval_schedule(shapes, img_sizes, max_size, lattice: int, num_class: int, batch: int,
                  pack: bool = True):
    """The chunks one ``batched_metrics_from_originals`` call runs over
    originals of ``shapes``: a list of (canvas (h, w), real tasks
    [(image, th, tw), ...], padded slots), where the padded slots repeat
    the last task up to ``batch``."""
    plans = [level_plan(h, w, img_sizes, max_size, lattice) for h, w in shapes]
    chunks = []
    for window in canvas_windows(shapes, lattice, num_class, batch):
        groups: Dict = {}
        for i in window:
            for th, tw in plans[i]:
                key = (round_up(th, lattice), round_up(tw, lattice))
                groups.setdefault(key, []).append((i, th, tw))
        if pack:
            pack_groups(groups, batch)
        for key, tasks in groups.items():
            for lo in range(0, len(tasks), batch):
                chunk = tasks[lo:lo + batch]
                chunks.append((key, chunk, batch - len(chunk)))
    return chunks


# -- chip_smoke.py:482-493 (bound_ms) and :1286-1296 (backward_bound_ms) --------
def pool_forward_bytes(extents, channels: int, element_size: int) -> int:
    """Bytes the pool's pad-aware forward must move: each slot's valid
    region of the map read once, its 50 means per channel written once,
    and its extents read."""
    pixels = sum(h * w for h, w in extents)
    n = len(extents)
    return (pixels + BINS * n) * channels * element_size + 8 * n


def pool_backward_bytes(shape, element_size: int) -> int:
    """Bytes the pool's backward must move over an (n, h, w, c) map: the
    grids' gradient read once and the map's gradient written once."""
    n, h, w, c = shape
    return (n * h * w + BINS * n) * c * element_size
