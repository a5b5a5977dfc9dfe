"""Device time of the kernels launched in the batch norms' spans
(``semseg::bn``, ``models/layers.BatchNorm2d``: the forward's statistics,
affine and running-statistics update; autograd launches the backward
outside the span, and a ``TPU.remat`` recompute would count here too), per
step of the traced stretch of a training cell."""

from h100_bench.spans import inside
from h100_bench.trace import union_s


def read(w):
    if w.info.get("kind") != "train":
        return None
    ops = inside(w, "semseg::bn")
    return union_s(ops) * 1e3 / w.info["steps"] if ops else None
