"""Device time of the kernels launched in the trainer's forward range
(``semseg::forward``, ``parallel/train_step.py``), per step of the traced
stretch of a training cell."""

from h100_bench.trace import union_s


def read(w):
    if w.info.get("kind") != "train":
        return None
    ops = w.under("semseg::forward")
    return union_s(ops) * 1e3 / w.info["steps"] if ops else None
