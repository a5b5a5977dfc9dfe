"""Training (``semseg_tpu/parallel``): the train state and step, the device
prefetcher, and the ranks of a data-parallel run (``distributed``: the
handshake, per-rank seeds and batch slices, the cross-rank canvas) and
each image's height split over a rank's devices (``spatial``). One process
per card, or per data group of cards under ``TPU.spatial``; the step over
the ranks is the JAX package's over the global batch."""

from .distributed import process_seed
from .mesh import device_prefetch
from .train_step import (
    TrainState,
    create_train_state,
    current_lrs,
    decay_mask,
    dropout_generator,
    make_optimizer,
    poly_schedule,
    stack_microbatches,
    train_step,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "current_lrs",
    "decay_mask",
    "device_prefetch",
    "dropout_generator",
    "make_optimizer",
    "poly_schedule",
    "process_seed",
    "stack_microbatches",
    "train_step",
]
