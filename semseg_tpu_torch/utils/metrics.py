"""Evaluation metrics and meters (``semseg_tpu/utils/metrics.py``, the
port's own copy).

Reproduces the reference's ``mit_semseg/utils.py``:

* ``accuracy`` (:128-133) — pixel accuracy over labeled (>=0) pixels;
* ``intersectionAndUnion`` (:136-156) — per-class histograms with the
  reference's exact +1-shift semantics: predictions on unlabeled pixels are
  zeroed out so they count toward neither intersection nor union;
* ``AverageMeter`` (:33-65).

mIoU aggregation follows eval.py:98-104: per-class IoU = Σintersection /
(Σunion + 1e-10), mean over classes.
"""

from __future__ import annotations

import numpy as np


class AverageMeter:
    """Computes and stores the average and current value."""

    def __init__(self):
        self.initialized = False
        self.val = None
        self.avg = None
        self.sum = None
        self.count = None

    def update(self, val, weight=1):
        if not self.initialized:
            self.val = val
            self.avg = val
            self.sum = val * weight
            self.count = weight
            self.initialized = True
        else:
            self.val = val
            self.sum += val * weight
            self.count += weight
            self.avg = self.sum / self.count

    def value(self):
        return self.val

    def average(self):
        return self.avg


def accuracy(preds, label):
    """Pixel accuracy over labeled pixels (utils.py:128-133)."""
    valid = label >= 0
    acc_sum = (valid * (preds == label)).sum()
    valid_sum = valid.sum()
    acc = float(acc_sum) / (float(valid_sum) + 1e-10)
    return acc, valid_sum


def intersectionAndUnion(imPred, imLab, numClass):
    """Per-class intersection/union histograms (utils.py:136-156).

    Uses the +1 shift so class ids are 1..numClass and 0 means unlabeled;
    predictions on unlabeled pixels are suppressed from both histograms.
    """
    imPred = np.asarray(imPred).copy() + 1
    imLab = np.asarray(imLab).copy() + 1
    imPred = imPred * (imLab > 0)

    intersection = imPred * (imPred == imLab)
    area_intersection, _ = np.histogram(
        intersection, bins=numClass, range=(1, numClass)
    )
    area_pred, _ = np.histogram(imPred, bins=numClass, range=(1, numClass))
    area_lab, _ = np.histogram(imLab, bins=numClass, range=(1, numClass))
    area_union = area_pred + area_lab - area_intersection
    return area_intersection, area_union


def miou_from_meters(intersection_sum, union_sum):
    iou = intersection_sum / (union_sum + 1e-10)
    return iou, iou.mean()
