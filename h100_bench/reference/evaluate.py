"""Plain reference of the multi-scale evaluation protocol, one image at a
time.

For each scale: the level, the original resampled with Pillow's BILINEAR
filter (a triangle whose support widens with the downsampling ratio, as
Pillow's ``precompute_coeffs`` builds it) to the level's size on the
lattice, in float64 then float32; ImageNet normalisation; the level placed
at the top left of its canvas with zeros beyond it; the forward with the
pyramid pools over the level's own extent; the logits of that extent
resized bilinearly (half-pixel centres) to the label's size; softmax over
the classes. The scores are summed over scales, the argmax taken, and the
counts of ``utils.intersectionAndUnion`` formed: correct pixels, labelled
pixels, and per class the intersection and the union (void = -1 counts in
neither). ``confident_labels`` makes the label map that the correctness
check evaluates an image against: the argmax where it is clear.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .model import Model

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def pil_bilinear_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out_size, in_size) float64 resampling matrix of Pillow's BILINEAR
    filter."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the bilinear filter's support is 1
    center = (np.arange(out_size) + 0.5) * scale
    k = np.arange(in_size)
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size)
    x = (k[None, :] + 0.5 - center[:, None]) / filterscale
    w = np.clip(1.0 - np.abs(x), 0.0, None)
    w *= (k[None, :] >= xmin[:, None]) & (k[None, :] < xmax[:, None])
    return w / w.sum(axis=1, keepdims=True)


def level(original: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """(3, th, tw) float32 normalised level of an (H, W, 3) uint8 original."""
    h, w = original.shape[:2]
    dev = original.device
    mh = torch.from_numpy(pil_bilinear_matrix(th, h)).to(dev)
    mw = torch.from_numpy(pil_bilinear_matrix(tw, w)).to(dev)
    x = torch.einsum("oh,hwc->owc", mh, original.to(torch.float64))
    x = torch.einsum("pw,owc->opc", mw, x).to(torch.float32)
    mean = torch.tensor(MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(STD, dtype=torch.float32, device=dev)
    return ((x / 255.0 - mean) / std).permute(2, 0, 1)


def counts(pred: torch.Tensor, label: torch.Tensor, num_class: int) -> np.ndarray:
    """[correct, labelled, intersection(C), union(C)] of an argmax map
    against a label map (-1 void), as float64."""
    valid = label >= 0
    hit = valid & (pred == label)
    inter = torch.bincount(label[hit], minlength=num_class)[:num_class]
    area_pred = torch.bincount(pred[valid], minlength=num_class)[:num_class]
    area_lab = torch.bincount(label[valid], minlength=num_class)[:num_class]
    union = area_pred + area_lab - inter
    head = torch.stack([hit.sum(), valid.sum()])
    return torch.cat([head, inter, union]).double().cpu().numpy()


@torch.no_grad()
def image_scores(model: Model, original: torch.Tensor, size,
                 levels: Sequence[Tuple[int, int, int, int]]) -> torch.Tensor:
    """(C, H, W) scores of one image at label size ``size``, summed over
    its levels. ``levels``: per scale (th, tw, canvas_h, canvas_w);
    ``original`` (H0, W0, 3) uint8 on the reference's device."""
    H, W = size
    stride = model.arch.logit_stride
    total = None
    for th, tw, ch, cw in levels:
        x = torch.zeros((1, 3, ch, cw), dtype=torch.float32, device=original.device)
        x[0, :, :th, :tw] = level(original, th, tw)
        logits, _ = model.forward(x, valid_hw=[(th, tw)])
        logits = logits[:, :, :math.ceil(th / stride), :math.ceil(tw / stride)]
        scores = torch.softmax(F.interpolate(logits, size=(H, W), mode="bilinear",
                                             align_corners=False), dim=1)[0]
        total = scores if total is None else total + scores
    return total


def confident_labels(scores: torch.Tensor, share: float) -> torch.Tensor:
    """(H, W) int32 labels from (C, H, W) scores: the argmax on the
    ``share`` of pixels whose margin (best score less the second) is
    largest, void (-1) on the rest, where a rounding can tip the argmax."""
    top = scores.topk(2, dim=0).values
    margin = (top[0] - top[1]).flatten()
    k = max(int(round((1.0 - share) * margin.numel())), 1)
    cut = margin.kthvalue(k).values
    return torch.where(top[0] - top[1] > cut, scores.argmax(0), -1).to(torch.int32)


def image_counts(model: Model, original: torch.Tensor, label: torch.Tensor,
                 levels: Sequence[Tuple[int, int, int, int]]) -> np.ndarray:
    """The counts of one image against ``label`` ((H, W) int, -1 void)."""
    scores = image_scores(model, original, label.shape, levels)
    return counts(scores.argmax(0), label.long(), model.arch.num_class)
