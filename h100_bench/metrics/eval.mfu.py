"""Useful forward FLOPs of an evaluation cell's untraced window (every
image's levels at their own sizes, no padded or repeated slot, counted by
the plain reference's convolutions) over the window's time, as a share of
the card's bf16 dense peak (989 TFLOP/s, NVIDIA H100 SXM at 700 W). Read
in the traced run, whose window runs untraced."""

from h100_bench.frozen import BF16_DENSE_FLOPS


def read(w):
    if w.info.get("kind") != "eval" or not w.device:
        return None
    return 100.0 * w.info["window_flops"] / w.info["window_s"] / BF16_DENSE_FLOPS
