"""Training CLI (``semseg_tpu/cli/train.py``), on one card or several.

    python -m semseg_tpu_torch.cli.train --cfg config/ade20k-resnet50dilated-ppm_deepsup.yaml \\
        [--device cuda] [--devices N | --gpus 0-3 | --multihost] [TRAIN.num_epoch 20 ...]

Per epoch: ``TRAIN.epoch_iters`` SGD steps over aspect-binned batches from
``TrainLoader`` (``TRAIN.workers`` threads), uploaded ahead of the step by
``device_prefetch``, then a checkpoint into ``cfg.DIR`` (the reference's
``encoder_/decoder_epoch_N.pth`` pair, the full train state and
``history_epoch_N.json``; asynchronous with ``TPU.async_checkpoint``).
``TRAIN.start_epoch N`` resumes from epoch N's train state: step count,
learning rate, momentum buffers and batch-norm statistics continue.

Each epoch's data stream is seeded from ``TRAIN.seed``, the epoch, the rank
and the worker, and each step's dropout from ``TRAIN.seed`` and the step,
so a run resumed at epoch N repeats the uninterrupted run's epochs after N
(with one worker; more workers interleave their streams in arrival order).
The JAX CLI keeps one stream across epochs and restarts it on resume.

Data parallelism, one process (rank) per card, as many as the JAX CLI's
``build_train_mesh`` takes devices: ``TPU.data_parallel``, else
``--devices N`` (or ``--gpus 0-3``, whose length counts), else every
visible card. The ranks run on the first cards of this host (fewer if fewer
are visible, as the JAX package's ``make_mesh`` slices its device list),
NCCL between them; with ``--device cpu`` that many gloo ranks on the CPU,
and one process when neither names a number. ``--multihost`` joins a run whose ranks are started
elsewhere, one per card, named by ``SEMSEG_COORDINATOR`` /
``SEMSEG_NUM_PROCESSES`` / ``SEMSEG_PROCESS_ID`` or by torchrun's
variables (``parallel.distributed.initialize``). The global batch is
``TRAIN.batch_size_per_gpu`` times the ranks, and each step is the JAX
package's data-parallel step over it (``parallel.train_step``). Only rank 0
logs and writes checkpoints; every rank reads one on resume.

Runs on the card unless ``--device cpu``. ``--profile DIR`` writes a
``torch.profiler`` trace of rank 0's first steps. ``TPU.remat`` recomputes
each ResNet block's activations in the backward
(``models.resnet.ResBlock``); ``TPU.train_fast_decode`` decodes training
JPEGs at a reduced scale (``data.TrainDataset``).

``TPU.spatial S`` > 1 is the JAX trainer's hybrid data x spatial mesh
(``semseg_tpu/cli/train.py:41-69``, ``build_train_mesh``): each image's
height is split in S row bands, and each rank is one data group that
drives its S devices (``parallel.train_step``, ``parallel/spatial.py``).
``TPU.data_parallel`` or ``--devices`` count the data groups; without
either, every visible card divided by S, which must divide it. With a bare
``--device cuda`` rank r's bands run on cards ``[r*S, (r+1)*S)``; with
``cuda:K`` or ``cpu`` every band runs on that device (one data group
unless a count is given). As in JAX, the hybrid mesh is single-host
(``--multihost`` raises), and ``TPU.remat`` has no banded form yet (ROADMAP
item 17e).
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from semseg_tpu_torch.checkpoint import (
    AsyncSaver,
    load_pretrained_encoder,
    pretrained_backbone_path,
    restore_train_state,
    save_train_state,
)
from semseg_tpu_torch.config import cfg as _default_cfg
from semseg_tpu_torch.data import TrainDataset, TrainLoader
from semseg_tpu_torch.models import ModelBuilder
from semseg_tpu_torch.parallel import (
    create_train_state,
    current_lrs,
    device_prefetch,
    distributed,
    dropout_generator,
    process_seed,
    stack_microbatches,
    train_step,
)
from semseg_tpu_torch.utils import AverageMeter, parse_devices, setup_logger

PROFILE_STEPS = 5


def epoch_batches(cfg, epoch, device):
    """Epoch ``epoch``'s batches on ``device``: a generator that stops its
    loader and prefetch thread when closed. A data-parallel rank's batches
    are its slice of the global batch, padded on the prefetch thread to the
    ranks' common canvas."""
    accum = cfg.TPU.grad_accum
    loader = TrainLoader(
        lambda worker: TrainDataset(
            cfg.DATASET.root_dataset, cfg.DATASET.list_train, cfg.DATASET,
            batch_per_gpu=cfg.TRAIN.batch_size_per_gpu * accum,
            seed=process_seed(cfg.TRAIN.seed + epoch, worker),
            bucket_step=cfg.TPU.bucket_step, raw_transport=cfg.TPU.device_preproc,
            fast_decode=cfg.TPU.train_fast_decode,
        ),
        num_workers=cfg.TRAIN.workers, prefetch=cfg.TPU.prefetch * 4,
    )
    exchange = None
    if distributed.process_count() > 1:
        exchange = distributed.CanvasExchange(epoch)
    host = iter(loader)
    if accum > 1:
        host = (stack_microbatches(b, accum) for b in host)
    put = None if exchange is None else functools.partial(
        distributed._sync_batch_canvas, exchange=exchange, microbatched=accum > 1)
    batches = device_prefetch(host, device, depth=cfg.TPU.prefetch, put=put)
    try:
        yield from batches
    finally:
        batches.close()
        if exchange is not None:
            exchange.close()
        loader.close()


def train_one_epoch(state, batches, cfg, epoch, history, logger, profile_dir=""):
    """``TRAIN.epoch_iters`` steps with the reference's meters; the loss and
    accuracy leave the device only every ``disp_iter`` steps (and at the
    end), where a non-finite loss raises ``FloatingPointError``."""
    batch_time, data_time = AverageMeter(), AverageMeter()
    ave_loss, ave_acc = AverageMeter(), AverageMeter()
    prof = None
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if torch.cuda.is_available() else [])
        prof = profile(activities=acts)
        prof.start()

    pending = []
    tic = time.time()
    for i in range(cfg.TRAIN.epoch_iters):
        batch = next(batches)
        data_time.update(time.time() - tic)
        step = state.step
        metrics = train_step(state, batch, dropout_generator(cfg.TRAIN.seed, step),
                             cfg.TPU.grad_accum)
        pending.append(torch.stack([metrics["loss"], metrics["acc"]]))
        if (i + 1) % cfg.TRAIN.disp_iter == 0 or i + 1 == cfg.TRAIN.epoch_iters:
            for k, (loss, acc) in enumerate(torch.stack(pending).tolist()):
                if not np.isfinite(loss):
                    raise FloatingPointError(
                        f"non-finite loss {loss} at epoch {epoch + 1} iter "
                        f"{i + 2 - len(pending) + k}: lower TRAIN.lr_*, or inspect "
                        "the batch around this iteration"
                    )
                ave_loss.update(loss)
                ave_acc.update(acc * 100)
            pending.clear()
        batch_time.update(time.time() - tic)
        tic = time.time()

        if prof is not None and i + 1 == min(PROFILE_STEPS, cfg.TRAIN.epoch_iters):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "train_trace.json"))
            logger.info(f"Wrote a profiler trace of {i + 1} steps to {profile_dir}")
            prof = None
        if (i + 1) % cfg.TRAIN.disp_iter == 0:
            lr_enc, lr_dec = current_lrs(cfg, step)
            logger.info(
                f"Epoch: [{epoch + 1}][{i + 1}/{cfg.TRAIN.epoch_iters}], "
                f"Time: {batch_time.average():.2f}, Data: {data_time.average():.2f}, "
                f"lr_encoder: {lr_enc:.6f}, lr_decoder: {lr_dec:.6f}, "
                f"Accuracy: {ave_acc.average():4.2f}, Loss: {ave_loss.average():.6f}"
            )
            history["train"]["epoch"].append(epoch + (i + 1) / cfg.TRAIN.epoch_iters)
            history["train"]["loss"].append(ave_loss.value())
            history["train"]["acc"].append(ave_acc.value())
    if cfg.TRAIN.epoch_iters % cfg.TRAIN.disp_iter:
        logger.info(f"Epoch: [{epoch + 1}] done, Accuracy: {ave_acc.average():4.2f}, "
                    f"Loss: {ave_loss.average():.6f}")


def rank_count(device, requested: int, data_parallel: int = 0) -> int:
    """Ranks for ``TPU.data_parallel`` or else ``--devices requested``, as
    the JAX CLI sizes its mesh (``semseg_tpu/cli/train.py:51``): on cards
    the first ``min(n, visible)``, every visible card when both are 0; on
    the CPU ``n``, one process when both are 0."""
    n = data_parallel or requested
    if torch.device(device).type != "cuda":
        return max(n, 1)
    return distributed.visible_cards(n or torch.cuda.device_count())


def train_mesh(device, requested: int, data_parallel: int = 0, spatial: int = 1):
    """(data groups, spatial): JAX's ``build_train_mesh`` shape. Without
    ``spatial`` the ranks of ``rank_count``; with it ``TPU.data_parallel``
    or ``--devices`` data groups, else (on cards) every visible card
    divided by ``spatial``, which must divide it; on the CPU or one named
    card one group unless a count is given."""
    if spatial <= 1:
        return rank_count(device, requested, data_parallel), 1
    groups = data_parallel or requested
    d = torch.device(device)
    if d.type != "cuda" or d.index is not None:
        return max(groups, 1), spatial
    total = distributed.visible_cards(torch.cuda.device_count())
    if not groups:
        if total % spatial:
            raise ValueError(f"TPU.spatial={spatial} must divide the device count {total}")
        groups = total // spatial
    if groups * spatial > total:
        raise ValueError(f"{groups} data groups x TPU.spatial {spatial} need "
                         f"{groups * spatial} cards; {total} visible")
    return groups, spatial


def load_cfg(args):
    """The config of ``args``: defaults < ``--cfg`` < ``opts``."""
    cfg = _default_cfg.clone()
    cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    return cfg


def _rank_main(rank, args, world, port):
    """Rank ``rank`` of ``--devices world`` (``torch.multiprocessing.spawn``)."""
    if torch.device(args.device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    rendezvous = dict(coordinator_address=f"127.0.0.1:{port}", num_processes=world,
                      process_id=rank)
    spatial = load_cfg(args).TPU.spatial
    if spatial > 1:  # the rank's device is its group's first
        rendezvous["device"] = distributed.group_devices(args.device, rank, spatial)[0]
    run(args, rendezvous)


def run(args, rendezvous=None):
    """Train in this process: alone, or with ``rendezvous`` (arguments of
    ``distributed.initialize``; ``{}`` reads the environment) as one rank.
    A process group begun here ends here. Returns ``(state, history)``."""
    if rendezvous is None:
        return _train(args, torch.device(args.device), None)
    joined = not dist.is_initialized()
    device = distributed.initialize(**{"device": args.device, **rendezvous})
    joined = joined and dist.is_initialized()
    try:
        return _train(args, device, dist.group.WORLD if dist.is_initialized() else None)
    finally:
        if joined:
            distributed.shutdown()


def _train(args, device, group):
    cfg = load_cfg(args)
    rank, world = distributed.process_index(), distributed.process_count()
    logger = setup_logger(distributed_rank=rank)
    logger.info(f"Loaded configuration file {args.cfg}")
    os.makedirs(cfg.DIR, exist_ok=True)
    if distributed.is_primary():
        with open(os.path.join(cfg.DIR, "config.yaml"), "w") as f:
            f.write(cfg.dump())
    np.random.seed(cfg.TRAIN.seed)
    torch.manual_seed(cfg.TRAIN.seed)
    spatial = cfg.TPU.spatial
    bands = distributed.group_devices(args.device, rank, spatial) if spatial > 1 else None
    if bands is not None:
        device = bands[0]
    logger.info(f"Mesh: {world * spatial} device(s)"
                + (f" ({world}-way data x {spatial}-way spatial)" if bands else "")
                + f" / {world} process(es); global batch {cfg.TRAIN.batch_size_per_gpu * world}"
                + (f" x {cfg.TPU.grad_accum} grad-accum microbatches"
                   if cfg.TPU.grad_accum > 1 else "") + f"; rank 0 on {device}"
                + (f", its bands on {[str(d) for d in bands]}" if bands else ""))

    model = ModelBuilder.build_model(cfg, device=device, seed=cfg.TRAIN.seed)
    if cfg.MODEL.pretrained_encoder and not cfg.MODEL.weights_encoder \
            and cfg.TRAIN.start_epoch == 0:
        path = pretrained_backbone_path(cfg.MODEL.arch_encoder)
        if path:
            load_pretrained_encoder(model.encoder, path)
            logger.info(f"Encoder initialised from {path}")
    state = create_train_state(cfg, model, group, spatial_devices=bands)
    # A resumed run's history holds only the epochs it runs, as in the JAX CLI.
    history = {"train": {"epoch": [], "loss": [], "acc": []}}
    if cfg.TRAIN.start_epoch > 0:
        restore_train_state(cfg.DIR, cfg.TRAIN.start_epoch, state)
        logger.info(f"Resumed from epoch {cfg.TRAIN.start_epoch} at step {state.step}")
    model.train()

    saver = AsyncSaver() if cfg.TPU.async_checkpoint else None
    try:
        for epoch in range(cfg.TRAIN.start_epoch, cfg.TRAIN.num_epoch):
            batches = epoch_batches(cfg, epoch, device)
            profile = args.profile if epoch == cfg.TRAIN.start_epoch and rank == 0 else ""
            try:
                train_one_epoch(state, batches, cfg, epoch, history, logger, profile)
            finally:
                batches.close()
            if saver is not None:
                saver.save(cfg.DIR, epoch + 1, state, history)
                logger.info(f"Saving checkpoint epoch_{epoch + 1} (async)")
            else:
                save_train_state(cfg.DIR, epoch + 1, state, history)
                logger.info(f"Saved checkpoint epoch_{epoch + 1}")
    finally:
        if saver is not None:
            unwinding = sys.exc_info()[0] is not None
            try:
                saver.close()
            except Exception:
                if not unwinding:
                    raise
                logger.exception("checkpoint writer failed during shutdown")
            if not unwinding:
                distributed.barrier()  # the last file is written before any rank returns
    logger.info("Training Done!")
    return state, history


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="semseg_tpu_torch training")
    parser.add_argument("--cfg", default="config/ade20k-resnet50dilated-ppm_deepsup.yaml")
    parser.add_argument("--devices", type=int, default=0,
                        help="cards to train on, one process each (0 = TPU.data_parallel, "
                             "else every visible card); more than are visible: every "
                             "visible card; with --device cpu, gloo processes on the CPU "
                             "(0: one)")
    parser.add_argument("--gpus", default=None,
                        help="reference CLI parity: the device list's length sizes "
                             "--devices (an explicit --devices wins)")
    parser.add_argument("--profile", default="",
                        help=f"write a torch.profiler trace of the first {PROFILE_STEPS} "
                             "steps into this directory")
    parser.add_argument("--multihost", action="store_true",
                        help="join a run of one process per card started elsewhere: "
                             "SEMSEG_COORDINATOR (host:port of rank 0), "
                             "SEMSEG_NUM_PROCESSES, SEMSEG_PROCESS_ID, or torchrun's "
                             "MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE/LOCAL_RANK")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)
    if args.gpus and not args.devices:
        args.devices = len(parse_devices(args.gpus))
    return args


def check_spatial(cfg, multihost: bool) -> None:
    """What ``TPU.spatial`` > 1 cannot combine with: several hosts (as in
    JAX, ``semseg_tpu/cli/train.py:52-56``) and remat (no banded form yet)."""
    if cfg.TPU.spatial <= 1:
        return
    if multihost:
        raise NotImplementedError("TPU.spatial hybrid training is single-host; combine "
                                  "--multihost with pure data parallelism instead")
    if cfg.TPU.remat:
        raise NotImplementedError(
            f"TPU.remat with TPU.spatial {cfg.TPU.spatial}: the banded forward has no remat "
            "yet (ROADMAP item 17e); drop one of the two")


def main(argv=None):
    """Trains as ``argv`` says; returns ``(state, history)`` when this
    process trained, None when it started ranks that did."""
    args = parse_args(argv)
    cfg = load_cfg(args)
    check_spatial(cfg, args.multihost)
    if args.multihost:
        return run(args, {})
    asked = cfg.TPU.data_parallel or args.devices
    ranks, spatial = train_mesh(args.device, args.devices, cfg.TPU.data_parallel,
                                cfg.TPU.spatial)
    if ranks < asked:
        setup_logger().info(f"{ranks} card(s) visible: training on {ranks} of the "
                            f"{asked} asked for")
    elif not asked and ranks > 1:
        setup_logger().info(f"training on every visible card: {ranks}"
                            + (f" data groups of {spatial} cards" if spatial > 1 else ""))
    if ranks == 1:
        return run(args)
    torch.multiprocessing.spawn(_rank_main, args=(args, ranks, distributed.free_port()),
                                nprocs=ranks)
    return None


if __name__ == "__main__":
    main()
