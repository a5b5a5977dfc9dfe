"""Device time of the kernels launched in the convolutions' spans
(``semseg::conv``, ``models/layers.Conv2d``: the f32 weight's cast and the
convolution), per image, in the traced call of an evaluation cell."""

from h100_bench.spans import inside
from h100_bench.trace import union_s


def read(w):
    if w.info.get("kind") != "eval":
        return None
    ops = inside(w, "semseg::conv")
    return union_s(ops) * 1e3 / w.info["images"] if ops else None
