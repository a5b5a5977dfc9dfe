"""Utilities: logging, meters, metrics, visualization (``semseg_tpu/utils``,
the port's own copy of what its CLIs call).

Covers the reference's ``mit_semseg/utils.py`` and the color palette /
class-name assets (``data/color150.npy``, ``data/object150_info.csv``).
"""

from __future__ import annotations

import csv
import logging
import os
import re
import sys
from functools import lru_cache

import numpy as np

from .metrics import AverageMeter, accuracy, intersectionAndUnion, miou_from_meters

__all__ = [
    "AverageMeter",
    "accuracy",
    "intersectionAndUnion",
    "miou_from_meters",
    "setup_logger",
    "find_recursive",
    "colorEncode",
    "load_colors",
    "load_class_names",
    "unique",
    "parse_devices",
]

_REPO_DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "data",
)


def setup_logger(distributed_rank=0, filename="log.txt"):
    """Stdout logger matching the reference format (utils.py:10-22)."""
    logger = logging.getLogger("Logger")
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if distributed_rank > 0:
        return logger
    if not logger.handlers:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.DEBUG)
        fmt = "[%(asctime)s.%(msecs)03d %(process)d %(filename)s:%(lineno)d] %(message)s"
        ch.setFormatter(logging.Formatter(fmt, datefmt="%m%d %H:%M:%S"))
        logger.addHandler(ch)
    return logger


def find_recursive(root_dir, ext=".jpg"):
    """Recursively list files with extension (utils.py:25-30)."""
    files = []
    for root, _dirnames, filenames in os.walk(root_dir):
        for filename in filenames:
            if filename.lower().endswith(ext):
                files.append(os.path.join(root, filename))
    return sorted(files)


@lru_cache(maxsize=1)
def load_colors(path=None):
    """The 150-class color palette (converted from data/color150.mat)."""
    return np.load(path or os.path.join(_REPO_DATA, "color150.npy"))


@lru_cache(maxsize=1)
def load_class_names(path=None):
    """Idx -> name map from object150_info.csv (its 6th column)."""
    names = {}
    with open(path or os.path.join(_REPO_DATA, "object150_info.csv")) as f:
        for row in csv.reader(f):
            if row[0] == "Idx":
                continue
            names[int(row[0])] = row[5].split(";")[0]
    return names


def unique(ar, return_index=False, return_inverse=False, return_counts=False):
    """np.unique passthrough (utils.py:68-108 reimplements this)."""
    return np.unique(
        ar,
        return_index=return_index,
        return_inverse=return_inverse,
        return_counts=return_counts,
    )


def colorEncode(labelmap, colors=None, mode="RGB"):
    """Colorize a label map with the 150-class palette (utils.py:111-125).

    Vectorized: one palette gather instead of a per-class loop. Label -1
    (unlabeled) maps to black.
    """
    if colors is None:
        colors = load_colors()
    colors = np.asarray(colors, dtype=np.uint8)
    labelmap = np.asarray(labelmap, dtype=np.int64)
    palette = np.concatenate([np.zeros((1, 3), np.uint8), colors], axis=0)
    out = palette[np.clip(labelmap + 1, 0, palette.shape[0] - 1)]
    if mode == "BGR":
        return out[..., ::-1]
    return out


def parse_devices(input_devices):
    """Parse device strings: '0-3', '0,1,2', 'gpu0' (utils.py:159-200)."""
    ret = []
    for d in input_devices.split(","):
        d = d.strip()
        if d.lower() == "cpu":
            ret.append("cpu")
            continue
        m = re.match(r"^(?:(?:gpu|tpu)?(\d+))(?:-(?:(?:gpu|tpu)?(\d+)))?$", d.lower())
        if m is None:
            raise ValueError(f"Cannot parse device: {d!r}")
        lo = int(m.group(1))
        hi = int(m.group(2)) if m.group(2) is not None else lo
        if hi < lo:
            raise ValueError("the end device must be larger than the start device")
        ret.extend(f"gpu{i}" for i in range(lo, hi + 1))
    return ret
