"""The pyramid pool's pad-aware forward (``ops/kernels/ppm_pool.py``,
``csrc/ppm_pool.cu``) against its roofline: the bytes it must move (each
real slot's conv5 extent read once, 50 means per channel written once) over
3.35 TB/s, as a share of the device time of the kernels launched in the
operator ``semseg_tpu_torch::pyramid_pool_valid``."""

from h100_bench.frozen import HBM_BYTES_PER_S
from h100_bench.trace import union_s


def read(w):
    if w.info.get("kind") != "eval":
        return None
    ops = w.under("semseg_tpu_torch::pyramid_pool_valid")
    if not ops:
        return None
    return 100.0 * w.info["pool_fwd_bytes"] / HBM_BYTES_PER_S / union_s(ops)
