"""Share of the device time under the batch norms' spans (``semseg::bn``,
``models/layers.BatchNorm2d``) taken by the hand-written BN kernel
(``csrc/bn_act.cu``: kernels named ``bn_act_...``), in the traced call of
an evaluation cell: 100 when every eval BN is the one kernel launch. None
where no such kernel runs under the span (a program without it)."""

from h100_bench.spans import inside
from h100_bench.trace import union_s

KERNEL = "bn_act_"


def read(w):
    if w.info.get("kind") != "eval":
        return None
    ops = inside(w, "semseg::bn")
    mine = [o for o in ops if KERNEL in o.name]
    if not mine:
        return None
    return 100.0 * union_s(mine) / union_s(ops)
