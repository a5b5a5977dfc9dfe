"""Device time of the kernels launched in the engine's epilogue spans
(``semseg::eval.epilogue``, ``engine.py``: each chunk's score canvases,
resizes, softmaxes and sums, and each finished image's counts), per image,
in the traced call of an evaluation cell."""

from h100_bench.spans import inside
from h100_bench.trace import union_s


def read(w):
    if w.info.get("kind") != "eval":
        return None
    ops = inside(w, "semseg::eval.epilogue")
    return union_s(ops) * 1e3 / w.info["images"] if ops else None
