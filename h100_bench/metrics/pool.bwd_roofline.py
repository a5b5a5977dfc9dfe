"""The pyramid pool's backward (``ops/kernels/ppm_pool.py``,
``csrc/ppm_pool.cu``) against its roofline: the bytes it must move (the
grids' gradient read once, the map's gradient written once) over 3.35 TB/s,
as a share of the device time of the kernels launched in the operator
``semseg_tpu_torch::pyramid_pool_backward``."""

from h100_bench.frozen import HBM_BYTES_PER_S
from h100_bench.trace import union_s


def read(w):
    if w.info.get("kind") != "train":
        return None
    ops = w.under("semseg_tpu_torch::pyramid_pool_backward")
    if not ops:
        return None
    return 100.0 * w.info["pool_bwd_bytes"] / HBM_BYTES_PER_S / union_s(ops)
