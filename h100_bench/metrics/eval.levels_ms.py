"""Device time of the engine's level derivation (the kernels launched in
``semseg::levels``, ``DevicePyramidEngine._levels``), per image, in the
traced stretch of an evaluation cell."""

from h100_bench.trace import union_s


def read(w):
    if w.info.get("kind") != "eval":
        return None
    ops = w.under("semseg::levels")
    return union_s(ops) * 1e3 / w.info["images"] if ops else None
