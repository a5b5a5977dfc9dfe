"""Device time of the NCCL kernels on the first rank of a data-parallel
training cell (DDP's gradient all-reduce, synchronised BN's all-reduce of
(s, ss) per layer forward and backward, the global loss's sums;
``parallel/distributed.py``, ``ops/norm.py``), per step of the traced
stretch."""

from h100_bench.trace import union_s


def read(w):
    if w.info.get("kind") != "train" or w.info.get("chips", 1) < 2:
        return None
    ops = [o for o in w.kernels() if "nccl" in o.name.lower()]
    return union_s(ops) * 1e3 / w.info["steps"] if ops else None
