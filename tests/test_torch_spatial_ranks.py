"""Rank-side programs of ``test_torch_spatial_train_step.py`` and
``test_torch_spatial_remat_ranks.py``: a rank of the data-parallel test's
two gloo ranks (``test_torch_dist_ranks.train_rank``) that also splits
each image's height in two bands on the CPU, one data group of JAX's
``make_mesh_2d(2, 2)``. Like ``test_torch_dist_ranks`` it imports PyTorch
and the port only, so a rank loads no JAX. No tests here.
"""

import functools

from test_torch_dist_ranks import remat_rank, train_rank

BANDS = 2


def _split_ranks():
    """``train_rank``'s train state split over ``BANDS`` CPU bands: its
    ``create_train_state`` (imported when it runs) takes the bands. Two
    threads a rank: the two ranks and JAX's step in the test's process
    share the cores (measured faster than a thread per core, alone too)."""
    import torch

    from semseg_tpu_torch import parallel

    torch.set_num_threads(2)
    parallel.create_train_state = functools.partial(parallel.create_train_state,
                                                    spatial_devices=["cpu"] * BANDS)


def spatial_train_rank(rank, out, case):
    """``train_rank`` split over ``BANDS`` CPU bands."""
    _split_ranks()
    train_rank(rank, out, case)


def spatial_remat_rank(rank, out, case):
    """``remat_rank`` split over ``BANDS`` CPU bands."""
    _split_ranks()
    remat_rank(rank, out, case)
