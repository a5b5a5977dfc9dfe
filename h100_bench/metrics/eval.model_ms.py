"""Device time of the kernels launched in the engine's network spans
(``semseg::eval.model``, ``engine.py``: the model on each chunk of levels),
per image, in the traced call of an evaluation cell."""

from h100_bench.spans import inside
from h100_bench.trace import union_s


def read(w):
    if w.info.get("kind") != "eval":
        return None
    ops = inside(w, "semseg::eval.model")
    return union_s(ops) * 1e3 / w.info["images"] if ops else None
