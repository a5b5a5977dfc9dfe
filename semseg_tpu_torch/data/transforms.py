"""Host-side image transforms (PIL/numpy), NHWC outputs
(``semseg_tpu/data/transforms.py``, the port's own copy).

Reproduces the reference's preprocessing exactly
(``mit_semseg/dataset.py:9-67``): PIL bilinear/nearest
resizes (PIL is the parity oracle — ``jax.image`` downsampling differs),
[0,1] scaling + ImageNet mean/std normalization, the label ``-1`` shift
(0 → void → ignore_index -1), and round-up-to-multiple padding math.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)

_RESAMPLE = {
    "nearest": Image.NEAREST,
    "bilinear": Image.BILINEAR,
    "bicubic": Image.BICUBIC,
}


def imresize(im: Image.Image, size, interp="bilinear") -> Image.Image:
    """Resize a PIL image to ``size`` = (width, height)."""
    try:
        resample = _RESAMPLE[interp]
    except KeyError:
        raise Exception("resample method undefined!")
    return im.resize(size, resample)


def img_transform(img: Image.Image) -> np.ndarray:
    """PIL RGB image → normalized float32 HWC array."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return (arr - MEAN) / STD


def segm_transform(segm: Image.Image) -> np.ndarray:
    """PIL 'L' label map → int32 HW array shifted to [-1, 149]."""
    return np.asarray(segm, dtype=np.int32) - 1


def round2nearest_multiple(x, p):
    """Smallest multiple of ``p`` that is >= ``x`` (dataset.py:65-67)."""
    return ((x - 1) // p + 1) * p


def scale_for(height, width, short_size, max_size):
    """Aspect-preserving scale: short side → ``short_size`` capped so the
    long side stays <= ``max_size`` (dataset.py:132-134)."""
    return min(
        short_size / float(min(height, width)),
        max_size / float(max(height, width)),
    )
