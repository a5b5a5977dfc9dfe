"""Training FLOPs of a training cell's untraced window (3 x the forward
FLOPs of each step's batch at its canvas, counted by the plain reference's
convolutions; no recompute) over the window's time, as a share of the
cards' bf16 dense peak (989 TFLOP/s each, NVIDIA H100 SXM at 700 W). Read in
the traced run, whose window runs untraced."""

from h100_bench.frozen import BF16_DENSE_FLOPS


def read(w):
    if w.info.get("kind") != "train" or not w.device:
        return None
    return 100.0 * w.info["window_flops"] / w.info["window_s"] / (
        BF16_DENSE_FLOPS * w.info.get("chips", 1))
