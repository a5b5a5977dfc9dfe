"""Training state, optimizer and the train step
(``semseg_tpu/parallel/train_step.py``), on one card or as one rank of a
data-parallel run.

* One ``torch.optim.SGD`` with two parameter groups per top-level module:
  the encoder at ``lr_encoder``, the decoder at ``lr_decoder``; in each,
  weight decay only on conv and linear weights (``decay_mask``), none on
  batch-norm parameters or biases (the reference's ``group_weight``).
  Momentum ``beta1``. Torch's SGD adds the decay to the gradient before the
  momentum buffer, as the JAX package's optax chain does.
* Poly learning rate ``lr * (1 - step / max_iters) ** lr_pow`` at the step
  before the increment, set on every group before each update.
* ``train_step`` normalises uint8 batches on the device
  (``ops.preproc.normalize_u8_masked``, zero pad in normalised space), runs
  the training forward and backward, and updates the parameters in place.
  With ``grad_accum = K`` the batch carries a leading microbatch axis
  (``stack_microbatches``): K forwards and backwards in order, each with
  its own batch-norm statistics (the running statistics advance in order),
  the gradients summed and divided by K into one update. All K microbatches
  share the loader batch's canvas, as in the JAX package.

Data parallelism (``create_train_state(..., group)``): one process per card,
each with its slice of the global batch, all slices on one canvas
(``distributed._sync_batch_canvas``). The step is the JAX package's over
the global batch (``make_mesh(N)`` + ``shard_batch`` + ``train_step``):
batch norm, dropout, the loss and the accuracy are the global batch's
(``models.segmentation.set_process_group``), and
``DistributedDataParallel`` all-reduces the gradients once per step, in
the backward of the last microbatch (``no_sync`` before it). DDP averages
over the ranks while each rank's loss carries its share of the global
loss's gradient, so each rank's loss is scaled by the number of ranks
before its backward. The batch-norm buffers are equal on every rank by
construction, so DDP does not broadcast them.

The hybrid data x spatial step (``create_train_state(...,
spatial_devices=[...])``, ``cli.train TPU.spatial``): each image's height
is split in row bands over the rank's devices, as the JAX package's
``make_mesh_2d`` + ``shard_batch`` split it over its ``spatial`` axis.
``train_step`` normalises the batch on the rank's first device as always;
the model's ``spatial`` forward (``models.segmentation``) then cuts images
and labels with ``BandPlan`` over the rank's canvas and runs the banded
forward, whose backward sums each parameter's gradient over the bands onto
the one model on the first device. Across the data groups the gradients
are summed by one all-reduce after the last microbatch's backward, not by
DDP: with bands on several cards autograd runs each card's part of the
backward on a thread of its own, so DDP's bucket all-reduces and BN's
statistics all-reduces (which ``models.segmentation`` chains into one
order, ``ops.norm.ordered_collectives``) could reach the group in another
order on each rank. The ranks start from rank 0's parameters and
buffers, as DDP's construction makes them.

Dropout draws from a CPU generator seeded from ``TRAIN.seed`` and the step
(``dropout_generator``), so a run repeats, and the card draws what the CPU
draws. The step's forward, backward and update run inside the spans
(``utils.spans``) ``semseg::forward``, ``semseg::backward`` (with DDP's
gradient all-reduce) and ``semseg::optimizer``.
"""

from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from semseg_tpu_torch.models.layers import Dropout2d
from semseg_tpu_torch.models.segmentation import check_banded, set_process_group
from semseg_tpu_torch.ops.preproc import normalize_u8_masked
from semseg_tpu_torch.utils.spans import span


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    max_iters: int
    lr_pow: float
    step: int = 0
    dropouts: List[Dropout2d] = field(default_factory=list)
    ddp: Optional[DistributedDataParallel] = None  # the model's data-parallel wrapper
    world: int = 1  # ranks of the data-parallel group
    spatial: Optional[List[torch.device]] = None  # the bands' devices (TPU.spatial > 1)
    group: Optional[dist.ProcessGroup] = None  # the ranks whose gradients a split step sums


def decay_mask(module: torch.nn.Module) -> Dict[str, bool]:
    """Parameter name → whether it takes weight decay: conv and linear
    weights only (the JAX package's ``kernel`` leaves)."""
    return {name: p.dim() > 1 for name, p in module.named_parameters()}


def poly_schedule(base_lr: float, max_iters: int, power: float):
    def schedule(step):
        frac = min(max(1.0 - step / max_iters, 0.0), 1.0)
        return base_lr * frac ** power

    return schedule


def current_lrs(cfg, step):
    """The (encoder, decoder) learning rates at ``step``."""
    max_iters = cfg.TRAIN.num_epoch * cfg.TRAIN.epoch_iters
    return tuple(poly_schedule(lr, max_iters, cfg.TRAIN.lr_pow)(step)
                 for lr in (cfg.TRAIN.lr_encoder, cfg.TRAIN.lr_decoder))


def make_optimizer(cfg, model) -> torch.optim.SGD:
    groups = []
    for part, lr in (("encoder", cfg.TRAIN.lr_encoder), ("decoder", cfg.TRAIN.lr_decoder)):
        module = getattr(model, part)
        mask = decay_mask(module)
        for decay in (True, False):
            params = [p for name, p in module.named_parameters() if mask[name] == decay]
            if params:
                groups.append({"params": params, "base_lr": lr, "lr": lr,
                               "weight_decay": cfg.TRAIN.weight_decay if decay else 0.0})
    return torch.optim.SGD(groups, lr=cfg.TRAIN.lr_encoder, momentum=cfg.TRAIN.beta1)


def create_train_state(cfg, model, group=None, spatial_devices=None) -> TrainState:
    """The train state of ``model``; with ``group`` (a process group, each
    rank on its own device) that of one data-parallel rank over it; with
    ``spatial_devices`` (more than one; the first is the model's) each
    image's height is split over them (module docstring)."""
    spatial = None
    if spatial_devices is not None and len(spatial_devices) > 1:
        spatial = [torch.device(d) for d in spatial_devices]
        check_banded(model)
    ddp, world = None, 1
    if group is not None:
        set_process_group(model, group)
        world = dist.get_world_size(group)
    if group is not None and spatial is None:
        with warnings.catch_warnings():
            # Newer PyTorch renames the switch; older has only this name.
            warnings.filterwarnings("ignore", message="`broadcast_buffers` is deprecated")
            ddp = DistributedDataParallel(model, process_group=group, broadcast_buffers=False)
    elif group is not None:
        with torch.no_grad():
            for t in [*model.parameters(), *model.buffers()]:
                dist.broadcast(t, dist.get_global_rank(group, 0), group=group)
    return TrainState(
        model=model, optimizer=make_optimizer(cfg, model),
        max_iters=cfg.TRAIN.num_epoch * cfg.TRAIN.epoch_iters, lr_pow=cfg.TRAIN.lr_pow,
        dropouts=[m for m in model.modules() if isinstance(m, Dropout2d)], ddp=ddp, world=world,
        spatial=spatial, group=group if spatial is not None else None,
    )


def dropout_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator that step ``step`` of a run seeded ``seed`` draws
    its dropout masks from."""
    return torch.Generator().manual_seed(seed * 1_000_003 + step)


def _images(batch):
    """NCHW (channels_last) float32 images of a batch; uint8 ones are
    normalised here with their valid extents."""
    img = batch["img_data"]
    if img.dtype == torch.uint8:
        vhw = batch["img_valid_hw"]
        img = normalize_u8_masked(img, vhw[:, 0], vhw[:, 1])
    return img.permute(0, 3, 1, 2)


def train_step(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None,
               grad_accum: int = 1) -> dict:
    """One SGD step on ``batch`` (tensors on the model's device:
    ``img_data`` (N, H, W, 3) float32, or uint8 with ``img_valid_hw`` (N, 2)
    int32, and ``seg_label`` (N, h, w) int32; with ``grad_accum`` > 1 each
    with a leading microbatch axis; a data-parallel rank's slice of the
    global batch; with ``state.spatial`` its images' rows are split over
    those devices). Updates ``state`` in place and returns ``{'loss',
    'acc'}`` (the global batch's) as device scalars (not fetched)."""
    opt = state.optimizer
    model = state.ddp if state.ddp is not None else state.model
    for m in state.dropouts:
        m.generator = generator
    for group in opt.param_groups:
        group["lr"] = poly_schedule(group["base_lr"], state.max_iters, state.lr_pow)(state.step)
    opt.zero_grad(set_to_none=True)
    if grad_accum == 1:
        micro = [batch]
    else:
        lead = batch["img_data"].shape[0]
        if lead != grad_accum:
            raise ValueError(f"grad_accum={grad_accum} expects a leading microbatch axis "
                             f"(stack_microbatches); got leading dim {lead}")
        micro = [{k: v[i] for k, v in batch.items()} for i in range(grad_accum)]
    split = {} if state.spatial is None else {"spatial": state.spatial}
    loss_sum = acc_sum = 0.0
    for i, mb in enumerate(micro):
        no_sync = state.ddp is not None and i + 1 < len(micro)
        with state.ddp.no_sync() if no_sync else contextlib.nullcontext():
            with span("semseg::forward"):
                loss, acc = model(_images(mb), seg_label=mb["seg_label"], **split)
            with span("semseg::backward"):
                (loss * state.world).backward()
        loss_sum = loss_sum + loss.detach()
        acc_sum = acc_sum + acc.detach()
    params = [p for group in opt.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:  # unused this step: a zero gradient, as in JAX
            p.grad = torch.zeros_like(p)
    if state.group is not None:
        with span("semseg::backward"):
            _average_over_ranks([p.grad for p in params], state.group, state.world)
    with span("semseg::optimizer"):
        if grad_accum > 1:
            for p in params:
                p.grad.div_(grad_accum)
        opt.step()
    state.step += 1
    return {"loss": loss_sum / grad_accum, "acc": acc_sum / grad_accum}


def _average_over_ranks(grads, group, world: int) -> None:
    """The gradients averaged over ``group``'s ranks in place, in one
    all-reduce of them flattened (what DDP computes, in one fixed order)."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat.div_(world)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def stack_microbatches(batch: dict, grad_accum: int) -> dict:
    """Host-side (K*N, ...) → (K, N, ...): microbatch i is rows
    [i*N, (i+1)*N) of the loader batch."""
    def split(x):
        n = x.shape[0]
        if n % grad_accum:
            raise ValueError(f"a batch of {n} does not split into {grad_accum} microbatches")
        return np.reshape(x, (grad_accum, n // grad_accum) + x.shape[1:])

    return {k: split(np.asarray(v)) for k, v in batch.items()}
