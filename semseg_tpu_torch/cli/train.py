"""Training CLI (``semseg_tpu/cli/train.py``), one card.

    python -m semseg_tpu_torch.cli.train --cfg config/ade20k-resnet50dilated-ppm_deepsup.yaml \\
        [--device cuda] [TRAIN.num_epoch 20 ...]

Per epoch: ``TRAIN.epoch_iters`` SGD steps over aspect-binned batches from
``TrainLoader`` (``TRAIN.workers`` threads), uploaded ahead of the step by
``device_prefetch``, then a checkpoint into ``cfg.DIR`` (the reference's
``encoder_/decoder_epoch_N.pth`` pair, the full train state and
``history_epoch_N.json``; asynchronous with ``TPU.async_checkpoint``).
``TRAIN.start_epoch N`` resumes from epoch N's train state: step count,
learning rate, momentum buffers and batch-norm statistics continue.

Each epoch's data stream is seeded from ``TRAIN.seed``, the epoch and the
worker, and each step's dropout from ``TRAIN.seed`` and the step, so a run
resumed at epoch N repeats the uninterrupted run's epochs after N (with one
worker; more workers interleave their streams in arrival order). The JAX
CLI keeps one stream across epochs and restarts it on resume.

Runs on the card unless ``--device cpu``. More than one card
(``--devices``/``--gpus``, ``--multihost``) is ROADMAP item 11. ``--profile
DIR`` writes a ``torch.profiler`` trace of the first steps.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

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
    dropout_generator,
    process_seed,
    stack_microbatches,
    train_step,
)
from semseg_tpu_torch.utils import AverageMeter, setup_logger

PROFILE_STEPS = 5


def epoch_batches(cfg, epoch, device):
    """Epoch ``epoch``'s batches on ``device`` (an iterator) and its loader."""
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
    host = iter(loader)
    if accum > 1:
        host = (stack_microbatches(b, accum) for b in host)
    return device_prefetch(host, device, depth=cfg.TPU.prefetch), loader


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


def _check_one_card(args):
    from semseg_tpu_torch.utils import parse_devices

    cards = args.devices or (len(parse_devices(args.gpus)) if args.gpus else 1)
    if cards > 1 or args.multihost:
        raise NotImplementedError(
            "the port trains on one card; multi-GPU training (DDP, synced batch "
            "norm, --multihost) is ROADMAP item 11"
        )


def main(argv=None):
    parser = argparse.ArgumentParser(description="semseg_tpu_torch training")
    parser.add_argument("--cfg", default="config/ade20k-resnet50dilated-ppm_deepsup.yaml")
    parser.add_argument("--devices", type=int, default=0,
                        help="cards to train on (0 = one; more is ROADMAP item 11)")
    parser.add_argument("--gpus", default=None, help="reference CLI parity: one card only")
    parser.add_argument("--profile", default="",
                        help=f"write a torch.profiler trace of the first {PROFILE_STEPS} "
                             "steps into this directory")
    parser.add_argument("--multihost", action="store_true", help="not ported (ROADMAP item 11)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)
    _check_one_card(args)

    cfg = _default_cfg.clone()
    cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    logger = setup_logger()
    logger.info(f"Loaded configuration file {args.cfg}")
    os.makedirs(cfg.DIR, exist_ok=True)
    with open(os.path.join(cfg.DIR, "config.yaml"), "w") as f:
        f.write(cfg.dump())
    np.random.seed(cfg.TRAIN.seed)
    torch.manual_seed(cfg.TRAIN.seed)
    if cfg.TPU.train_fast_decode:
        raise NotImplementedError("TPU.train_fast_decode needs the native JPEG decoder "
                                  "(ROADMAP item 14)")
    device = torch.device(args.device)
    logger.info(f"Device: {device}; batch {cfg.TRAIN.batch_size_per_gpu}"
                + (f" x {cfg.TPU.grad_accum} grad-accum microbatches"
                   if cfg.TPU.grad_accum > 1 else ""))

    model = ModelBuilder.build_model(cfg, device=device, seed=cfg.TRAIN.seed)
    if cfg.MODEL.pretrained_encoder and not cfg.MODEL.weights_encoder \
            and cfg.TRAIN.start_epoch == 0:
        path = pretrained_backbone_path(cfg.MODEL.arch_encoder)
        if path:
            load_pretrained_encoder(model.encoder, path)
            logger.info(f"Encoder initialised from {path}")
    state = create_train_state(cfg, model)
    history = {"train": {"epoch": [], "loss": [], "acc": []}}
    if cfg.TRAIN.start_epoch > 0:
        history = restore_train_state(cfg.DIR, cfg.TRAIN.start_epoch, state)
        logger.info(f"Resumed from epoch {cfg.TRAIN.start_epoch} at step {state.step}")
    model.train()

    saver = AsyncSaver() if cfg.TPU.async_checkpoint else None
    try:
        for epoch in range(cfg.TRAIN.start_epoch, cfg.TRAIN.num_epoch):
            batches, loader = epoch_batches(cfg, epoch, device)
            try:
                train_one_epoch(state, batches, cfg, epoch, history, logger,
                                args.profile if epoch == cfg.TRAIN.start_epoch else "")
            finally:
                batches.close()
                loader.close()
            if saver is not None:
                saver.save(cfg.DIR, epoch + 1, state, history)
                logger.info(f"Saving checkpoint epoch_{epoch + 1} (async)")
            else:
                save_train_state(cfg.DIR, epoch + 1, state, history)
                logger.info(f"Saved checkpoint epoch_{epoch + 1}")
    finally:
        if saver is not None:
            import sys

            unwinding = sys.exc_info()[0] is not None
            try:
                saver.close()
            except Exception:
                if not unwinding:
                    raise
                logger.exception("checkpoint writer failed during shutdown")
    logger.info("Training Done!")
    return state, history


if __name__ == "__main__":
    main()
