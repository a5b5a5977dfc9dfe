"""Device time of the kernels launched in the batch norms' spans
(``semseg::bn``, ``models/layers.BatchNorm2d``: the f32 affine on running
statistics and its casts), per image, in the traced call of an evaluation
cell."""

from h100_bench.spans import inside
from h100_bench.trace import union_s


def read(w):
    if w.info.get("kind") != "eval":
        return None
    ops = inside(w, "semseg::bn")
    return union_s(ops) * 1e3 / w.info["images"] if ops else None
