#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``semseg_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA. In order:

1. device: the card's name and power limit;
2. build: the CUDA kernels from ``semseg_tpu_torch/csrc`` (nvcc, sm_90a),
   with each kernel's registers and spills from ``-Xptxas -v`` (a spill
   fails the run);
3. each kernel against its plain PyTorch version at the main path's shapes:
   ``pyramid_pool`` dense, and its pad-aware form (``valid_hw``) on batches
   with mixed per-sample extents, in float32 and bfloat16, and at shapes
   that take its other paths (C not a multiple of 8, a map whose address is
   not 16-byte aligned, 1-row and 1-column segments, empty extents); two
   launches on the same input must agree bit for bit;
4. kernel and plain times (CUDA events, 10 warm-up runs, median of 50), each
   with the L2 cache warm and cold (a 256 MB buffer read between launches,
   outside the events), beside the bound (the bytes each call must read
   over 3.35 TB/s) and the device time of the kernel's two passes under
   ``torch.profiler``; for the dense form, as context, four
   ``F.adaptive_avg_pool2d`` calls and one ``torch.sum`` over the same map;
   the zoo's shapes (C = 512, UPerNet's small conv5 maps) among them. With
   ``--compare PATH`` it also times a library built
   from another ``ppm_pool.cu`` (an earlier version) in turns with this
   one: other, this, this, other (the backward too, after holding it bit
   for bit to the other build at every phase-8 check shape, and in phase
   12 the band form);
   then the BN kernel (``ops/kernels/bn_act.py``, its own library): its
   registers and spills, ``torch.equal`` to the plain chain at the
   flagship's eval maps (``BN_ACT_CHECKS``, channels_last, bf16 and f32,
   with and without a residual, each activation; under a gradient, the
   operator's backward against autograd's through the plain chain), NCHW
   and float64 maps refused, its time warm
   and L2-cold with the profiler's device time beside its bound (map and
   residual read once, output written once, over 3.35 TB/s) and the plain
   chain's (``BN_ACT_TIMED``), and the host time of one eval BN call with
   tracing off: the module with the kernel, the plain chain as the module
   ran it before, and the registered operator through the dispatcher;
5. the main paths at full width: the flagship resnet50dilated + ppm_deepsup
   with seeded random weights saved as a reference ``.pth`` pair, through
   ``cli.test`` (3 images, bucketed per-image engine), ``cli.eval --exact``,
   the default ``cli.eval`` (batched engine: batch 4, packed buckets,
   on-device metrics) and ``cli.eval --device-pyramid`` (levels derived on
   the card from the originals) over the same 9 labelled images, all 5
   scales; then every other shipped config (the zoo) through the default
   ``cli.eval`` (3 labelled images) and ``cli.test`` (1 image) at full
   width and its own scales, every BN of its ``cli.eval`` a BN kernel
   launch. The launch counts are read per path: the
   pad-aware form once per level in ``cli.test`` and once per scheduled
   chunk in the default and device-pyramid ``cli.eval`` (none in the C1
   configs), the dense form once per level in ``cli.eval --exact``; the
   three flagship eval paths must count the same labelled pixels, and every
   BN of theirs must launch the BN kernel;
6. steady state of the batched and exact engines on those images, and at
   bench.py's headline settings (batch 8, packed, step 8) the
   device-pyramid engine beside the batched engine, with the host PIL
   pyramid's time; a ``torch.profiler`` breakdown of one batched and one
   device-pyramid pass, with the device time of the ``pyramid_pool``
   kernels and of the level derivation in it;
7. float32 with TF32 off: card against CPU (exact engine), for the flagship
   and for every zoo config; the batched engine's device metrics against
   host metrics of its maps, and its maps, packed and unpacked, against
   the per-image bucketed engine; the levels derived on the card against
   PIL; the device-pyramid metrics against the host-pyramid engine's;
8. training: the ``pyramid_pool`` backward kernel against its plain version
   at the training shapes (conv5 of the largest canvas, of bench.py's
   448x608 batch 8, and of a small canvas; odd C, unaligned gradients,
   13x13, 4x5 and 1x1 maps; two launches bit-equal), timed warm and L2-cold
   beside its bound; the flagship in bf16 at batch 2 through ``cli.train``
   on 8 labelled JPEGs (epoch 1, then a resume into epoch 2, then
   ``cli.eval`` of the ``epoch_2.pth`` pair), with the pool's forward and
   backward launches equal to the steps run; the loss falling over 5 steps
   on one repeated batch (deterministic algorithms, so that the same five
   losses come every run); one float32 step (TF32 off) on the card against
   the CPU from the same weights and batch (loss, the gradients of layer4's
   last conv, a PPM branch conv and ``conv_last``, the BN statistics: a
   missing pool gradient moves layer4's by O(1)); one ``TRAIN.fix_bn``
   step (every BN in eval mode under a gradient) with each BN call one BN
   kernel launch, bit-equal to the same step with the plain chain under
   the BNs (deterministic algorithms); and steady state at
   bench.py's train shape (batch 8, 448x608) with peak memory at batch 2
   and 8 and a ``torch.profiler`` step broken down by kernel;
9. serving (run after the zoo phase): ``tools.export_serving`` exports the
   flagship (bf16) as a bundle of two buckets (448x608, 608x448) at batch
   4 on the card, with its export time and file sizes (each program file
   at most 5% of ``params.pt``); each program against the eager forward
   (argmax agreement) with one dense launch per program call and as many
   BN kernel launches as the eager forward makes; an f32
   bundle exported on the card against the same bundle exported on the CPU
   (TF32 off); then ``cli.serve`` on 127.0.0.1 over the bundle and over
   the live engine (5 scales, batch 8, packed): ``/healthz``, then 16 JPEG
   requests of shapes sampled from ``data/validation.odgt``, sent twice per
   round from 1, 4, 8 and 16 client threads, with req/s, mean batch fill,
   the server's latency percentiles (enqueue to result) and the client's
   (decode, pyramid and HTTP included) per round; every answer 200, and at one
   client each label map equal to the backend's own prediction of the
   decoded image, with more clients the bundle's within 0.999 of its
   request predicted alone at the slot of the batch it was served in (the
   program rounds the last slot of a full batch differently) and the live
   engine's closer to its own request than to any other; last, the live server with ``--max-queue 2`` under 16
   concurrent requests must answer some 503 and no 500;
10. data parallel on one card (after training): (a) two ranks, spawned
   processes on cuda:0 over gloo (NCCL refuses two ranks on one device),
   the flagship in float32 with TF32 off and dropout on, rank 0 with one
   448x608 image and rank 1 one 384x608 image (padded to rank 0's canvas
   through the store, with other void pixels), one step against one
   process on the card with the joined, padded batch of 2: loss, accuracy,
   every BN running statistic and ``iter``, and layer4's and the decoder's
   gradients, both ranks' states bit-equal, one dense and one backward pool
   launch per rank per step, and ms/step as a smoke (two ranks share the
   card); (b) ``cli.train --multihost`` as a world of 1 on NCCL from the
   SEMSEG_* variables on phase 8's data and settings (one loader worker,
   every step logged), its per-step losses against two single-card runs
   (bit-equal where those are; else the first step bit-equal and the
   nearest of three single-card runs within 3x their largest distance),
   NCCL the backend in use; (c) the eval CLI's engines, one and two on cuda:0
   through ``build_engines``' device list: ``--exact`` sums equal, the
   default batched path's mIoU within 1e-4 (PARITY.md's bucketed bar;
   the two engines take chunks of 4 images), with the launches counted.

11. the slice's modules (after phase 10): (a) the native host library
   (``semseg_tpu_torch.native``) built from the checkout with g++, its
   command and whether libjpeg was found printed; on phase 8's training
   JPEGs and the val set ``decode_jpeg_verified`` and the native 5-level
   pyramid bit-equal to PIL, ``TrainDataset`` batches native against
   ``SEMSEG_NO_NATIVE=1`` (uint8 bit-equal, float32 within 1e-6), and host
   times on one thread (pyramid per image PIL / native, a batch of 2 PIL /
   native / native with ``fast_decode``); (b) ``TPU.remat``: two float32
   steps (TF32 off) of the flagship at batch 2 with remat on and off from
   the same weights and batches under deterministic algorithms: bit-equal
   losses, accuracies, parameters, gradients and BN buffers (``iter``
   too), then bench.py's batch-8 448x608 step both
   ways (ms/step, peak memory: remat must lower it); (c) ``cli.serve
   --devices 2`` on cuda:0 over phase 9's bundle and the live engine, phase
   9's requests (the live engine the first half) at 1 and 4 clients with
   its rules, every backend taking batches; (d) ``cli.eval --profile`` over two val images: the trace names
   the pad-aware pool's kernels.

12. spatial (after phase 11): (a) the pool's band form
   (``pyramid_pool_band``: one band's per-bin f32 sums) against its plain
   version in float32 and bfloat16, at the flagship's conv5 split in 2 and
   4 bands, with odd C, a map whose address is not 16-byte aligned, bands
   of one row, bins straddling bands and an empty extent; each launch
   repeated bit for bit and the bands' sums turned into grids against the
   pad-aware form; one band's time L2-cold at (1, 75, 100, 2048) in 2 and 4
   bands beside its bound and the pad-aware form on the whole map; (b) the
   flagship at full width, each level's height split in 2 and 4 bands on
   cuda:0 (``InferenceEngine(spatial_devices=...)``), against the unsplit
   bucketed engine over phase 6's images: in float32 with TF32 off max
   |dscore| <= 2e-4 (the JAX package's bar, tests/test_engine.py:209), in
   bfloat16 argmax agreement >= 0.99, the band launches counted; (c)
   ``cli.eval --device cuda:0 --spatial 2`` end to end, two band launches
   per level and no other pool launch.

13. spatial training (after phase 12; ``cli.train TPU.spatial``): (a) the
   pool's band backward (``pyramid_pool_band_backward``: rows [row0, row0 +
   hb) of the dense backward) against its plain version in float32 and
   bfloat16, at the flagship's training conv5 maps (2, 40, 56, 2048) and
   (8, 56, 76, 2048) each in 2 and 4 bands, with odd C, unaligned
   gradients, bands of one row and bins straddling bands: each launch
   repeated bit for bit and each band bit-equal to the dense backward
   kernel's rows (with ``--compare``, also to the other build's band
   backward); the first band timed warm and L2-cold beside its bound, with
   the kernel's device time under the profiler (with ``--compare``, the
   other build's in turns); (b) the flagship at full width in float32
   (TF32 off, deterministic algorithms), batch 2 at 448x608, one step
   split in 2 and 4 bands on cuda:0 against the unsplit step from the same
   weights, batch and dropout generator, with phase 10 (a)'s limits (loss, accuracy, the
   gradients of phase 10's parameters and of the stem's first conv, every
   BN statistic, ``iter`` equal), the band forward and backward launched
   once per band and no dense pool; (c) bf16: the split step's loss falls
   over 5 steps on one repeated batch, and ms/step unsplit and in 2 and 4
   bands on cuda:0; (d) ``cli.train --device cuda:0 ... TPU.spatial 2``,
   one epoch of phase 8's data, writes its checkpoint pair.

14. the spatial zoo (after phase 13): UPerNet on the non-dilated ResNet-50
   and HRNetV2, whose band plans cut the canvas at stride 32, with the zoo
   phase's seeded weights. (a) the band form and the band backward on
   UPerNet's stride-32 conv5 maps: (1, 19, 25, 2048) in 2 and 4 bands
   (full and partial extents), the training maps (2 and 8, 14, 19, 2048)
   in 2 and 4 bands and in bands of 1-3 rows, each against its plain
   version, bit-equal on repeat, each backward band bit-equal to the dense
   backward's rows (and to the other build's with ``--compare``), the first
   band timed L2-cold beside its bound (the other build in turns); (b) each
   config split in 2 and 4 bands on cuda:0 against its unsplit engine over
   two of phase 6's images: float32 (TF32 off) within 2e-4 (HRNetV2) or
   1e-3 (UPerNet, whose random logits reach ~1e3) with the logits' largest
   relative difference printed, bf16 argmax agreement >= 0.99, a band
   launch per band and level of UPerNet's PPM, single-image latency
   unsplit and split; (c) one float32 step at batch 8, 448x608 (TF32 off,
   deterministic algorithms) split in 2 and 4 bands against the unsplit
   step: loss, accuracy, the stem's, a deep and the last conv's gradients,
   BN statistics, ``iter``; (d) bf16 ms/step and peak memory at batch 2,
   unsplit and in 2 and 4 bands, and ``cli.eval --spatial 2`` over one
   image and ``cli.train ... TPU.spatial 2`` for one epoch of phase 8's
   data, for each config.

15. ``TPU.remat`` under ``TPU.spatial`` (after phase 14): each banded ResNet
   block one checkpoint over its bands, recomputed in the backward with no
   collective. (a) the flagship in float32 (TF32 off, deterministic
   algorithms) at batch 2, 448x608, split in 2 and 4 bands on cuda:0: two
   steps with remat against two without from the same weights, batches and
   dropout generators, losses, accuracies, every parameter, gradient and
   BN buffer bit-equal, each of its 16 blocks recomputed once a step, the
   band forward and backward launched as without remat; (b) the same for
   ``ade20k-resnet50-upernet.yaml`` (stride 32) in 2 bands, one step; (c)
   bf16 ms/step, peak memory and the memory allocated between steps, remat
   on against off, at batch 2 in 2 and 4 bands and at bench.py's batch 8 in
   2: remat must lower the peak; (d) ``cli.train --device cuda:0 ...
   TPU.spatial 2 TPU.remat True`` for one epoch of phase 8's data.

With more than one visible card, a last check puts a rank or an engine on
every card: the ranks (NCCL) against one process as in 10 (a),
``cli.train --devices N`` for one epoch, ``cli.eval --exact --devices
N`` against one engine, ``cli.serve --devices N`` (a backend per card,
the bundle exported on card 0) as in 11 (c), the spatial engine over
the cards against one card (float32 within 2e-4) with its single-image
latency at 1, 2 and 4 cards, the split training step with its bands on
distinct cards against one card (as 13 (b)) with ms/step at 1, 2 and 4
cards, ``cli.train TPU.spatial 2`` over the cards (N / 2 data groups),
UPerNet's engine split over the cards against one card (as 14 (b)), and
phase 15's checks over the cards: 15 (a) with the bands on cuda:0-1 and
cuda:0-3, two NCCL ranks of two cards each (four cards) with remat on
against off (each rank's state bit-equal, as many all-reduces a step),
``cli.train --devices N/2 ... TPU.spatial 2 TPU.remat True``, both killed
after a timeout, and a batch-8 step with the default multithreaded backward
over the cards, remat against no remat, each gradient within its limit. Run with no arguments on one card, it needs one.

It ends with a JSON line of per-kernel results, the card's ``nvidia-smi``
name and power limit, and ``{"ok": true, "device": {...}}`` as the last
line. Any failure raises, so the exit code is non-zero and no result line
is printed. It never falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(HERE, "config", "ade20k-resnet50dilated-ppm_deepsup.yaml")
OUT_DIR = os.path.join(HERE, "build")  # the profiler table goes here
MAIN_SHAPE = (1, 75, 100, 2048)  # conv5 of a 600-px level
# The main path's shapes, then the kernel's other paths: C not a multiple
# of 8 (scalar loads), and a 13 x 13 map, whose segments include 1-row and
# 1-column ones.
CHECK_SHAPES = [
    ((1, 75, 100, 2048), "float32"), ((1, 75, 100, 2048), "bfloat16"),
    ((1, 38, 50, 2048), "float32"), ((1, 38, 50, 2048), "bfloat16"),
    ((2, 13, 17, 256), "float32"), ((1, 1, 1, 2048), "bfloat16"),
    ((1, 75, 100, 720), "bfloat16"),
    ((1, 75, 100, 250), "float32"), ((1, 75, 100, 250), "bfloat16"),
    ((1, 13, 13, 2048), "float32"), ((1, 13, 13, 2048), "bfloat16"),
    # resnet18dilated's conv5 (C = 512) on a batch of 4 levels.
    ((4, 75, 100, 512), "float32"), ((4, 75, 100, 512), "bfloat16"),
]
# A map whose data_ptr is one element past a 16-byte boundary.
UNALIGNED_SHAPE = (1, 75, 100, 2048)
# Pad-aware form: a batch-8 canvas with mixed extents (full, odd, 1x1,
# full height or width only), smaller canvases of the main path, odd C,
# and empty and one-row / one-column extents.
VALID_SHAPE = (8, 75, 100, 2048)
VALID_CHECKS = [
    (VALID_SHAPE, [[75, 100], [75, 99], [37, 51], [1, 1], [60, 100], [75, 13],
                   [49, 67], [2, 3]]),
    ((4, 38, 50, 2048), [[38, 50], [33, 41], [38, 7], [19, 50]]),
    ((2, 13, 17, 256), [[13, 17], [7, 9]]),
    ((2, 75, 100, 250), [[75, 100], [13, 61]]),
    ((3, 13, 13, 2048), [[0, 0], [1, 13], [13, 1]]),
    # The zoo's shapes: resnet18dilated's conv5 (C = 512), and UPerNet's
    # conv5 at output stride 32 (600 and 320 px levels).
    ((4, 75, 100, 512), [[75, 100], [60, 81], [37, 51], [1, 1]]),
    ((4, 19, 25, 2048), [[19, 25], [15, 19], [10, 13], [3, 2]]),
    ((4, 10, 13, 2048), [[10, 13], [8, 9], [5, 7], [1, 1]]),
]
# Timed cases (name, shape, extents or None for the dense form): the exact
# path's largest level, chip_smoke's batch-8 canvas, and the batched
# path's two canvases at full extent.
TIME_CASES = [
    ("dense", MAIN_SHAPE, None),
    ("valid", VALID_SHAPE, VALID_CHECKS[0][1]),
    ("valid", (4, 75, 100, 2048), [[75, 100]] * 4),
    ("valid", (4, 38, 50, 2048), [[38, 50]] * 4),
    ("valid", (4, 75, 100, 512), [[75, 100]] * 4),
    ("valid", (4, 19, 25, 2048), [[19, 25]] * 4),
]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# The pool's kernels as the profiler names them (substrings of the
# demangled names): the dense and pad-aware forms' two passes, the band
# form, the backward (the dense backward and the band backward). A profile
# check that finds none of a form's kernels fails.
FORWARD_KERNELS = ("ppm_cells_kernel", "ppm_combine_kernel")
BAND_KERNEL = "ppm_band_kernel"
BACKWARD_KERNEL = "ppm_pool_backward_kernel"
FLUSH_BYTES = 256 * 2**20
TEST_IMAGES = [(480, 640), (375, 500), (600, 451)]  # (H, W)
# Landscape images share buckets, portrait ones share buckets of 3 tasks
# (a padded last chunk) into whose spare slot the levels of the 510x390
# image fold, and a few buckets hold a single task.
EVAL_IMAGES = [(375, 500), (375, 500), (375, 500), (512, 384), (512, 384),
               (480, 640), (600, 451), (333, 500), (510, 390)]
# At 300/375 px the two levels of the 510x390 image fold into the buckets
# of the 512x384 one (8 rows of extra pad each).
F32_IMAGES = [(375, 500), (333, 500), (512, 384), (510, 390)]
# Argmax agreement with the per-image bucketed engine, per image, in f32.
# A task that is not folded is padded exactly as a per-image one. A folded
# task sees up to pack_max_pad_px more zero pad, which the convolutions
# carry in from the border (pad bleed): with random weights 8 rows of it
# flipped 3.0% of the 510x390 image's pixels on an H100. A misplaced canvas
# or wrong extents would drop agreement toward chance (1/150).
AGREE = 0.999
AGREE_FOLDED = 0.95
# The zoo phase: every other shipped config, full width, its own scales.
ZOO_CONFIGS = ["ade20k-resnet18dilated-ppm_deepsup.yaml",
               "ade20k-resnet101dilated-ppm_deepsup.yaml",
               "ade20k-mobilenetv2dilated-c1_deepsup.yaml", "ade20k-hrnetv2.yaml",
               "ade20k-resnet50-upernet.yaml", "ade20k-resnet101-upernet.yaml"]
ZOO_IMAGES = [(375, 500), (512, 384), (333, 500)]
POOLED_DECODERS = ("ppm", "ppm_deepsup", "upernet", "upernet_lite")
# Levels derived on the card against PIL (tests/test_device_pyramid.py:53-55):
# PIL rounds its filter coefficients and its output to 8 bits.
PIL_MAX, PIL_MEAN = 1.3, 0.5
# Device-pyramid metrics against the host-pyramid batched engine, per image
# as a share of its labelled pixels (tests/test_device_pyramid.py:140-145).
DP_ACC, DP_INTER, DP_UNION = 0.02, 0.02, 0.04
# The zoo's card against the CPU, f32: each level's logits within ZOO_REL of
# their largest magnitude (cuDNN and the CPU sum in other orders; a wrong
# weight, slot or layout moves them by O(1)), and argmax agreement of the
# exact engine's averaged scores. Random full-depth weights give logits from
# ~1e-2 (mobilenetv2) to ~1e8 (hrnetv2), so a probability difference is no
# scale-free test: resnet101dilated gave max |dp| 2.247e-03 at argmax
# agreement 1.0 on an H100; max |dp| is printed without a limit.
ZOO_REL, ZOO_AGREE = 1e-3, 0.999
# The backward kernel (phase 8): conv5 of the largest training canvas at
# imgMaxSize 1000 (640x1024), of bench.py's 448x608 batch 8, of a small
# canvas; then odd C, and maps whose segments are 1 pixel (13x13) or whose
# pixels lie in several bins of one scale per axis (4x5, 1x1).
BACKWARD_CHECKS = [(2, 80, 128, 2048), (8, 56, 76, 2048), (2, 40, 56, 2048), (2, 40, 56, 250),
                   (2, 13, 13, 2048), (2, 4, 5, 2048), (2, 1, 1, 2048)]
BACKWARD_TIMED = [(8, 56, 76, 2048), (2, 80, 128, 2048), (2, 40, 56, 2048)]
# Training on 8 labelled JPEGs, both orientations (aspect-binned batches).
TRAIN_IMAGES = [(375, 500), (500, 375), (480, 640), (640, 480), (333, 500), (512, 384),
                (600, 451), (375, 625)]
TRAIN_ITERS = 4  # per epoch, two epochs (the second one resumed)
# bench.py's train step (bench.py:243): batch 8, 448x608, random inputs.
BENCH_TRAIN = (8, 448, 608)
# Card against CPU, one float32 step (TF32 off): the loss within LOSS_REL,
# each gradient within GRAD_REL in relative norm, each BN statistic within
# STAT_REL of its largest magnitude. float32 against float64 on the CPU:
# gradients 1.3-2.9% apart in relative norm (deep layers; batch norm over
# the PPM's 1x1 grids, 2 values at batch 2, amplifies rounding), statistics
# up to 7.4e-4 (conv_last's BN, after a 3x3 conv over 4096 channels);
# without the pool's gradient layer4's last conv moves by 67%. On an H100
# the card against the CPU gave 2.7-4.9% and 1.5e-3. A statistic held in
# bf16 is off by up to 3.9e-3 (half a bf16 ulp), the biased variance by 2x
# on the PPM's 1x1 grids (n = 2).
LOSS_REL, GRAD_REL, STAT_REL = 1e-4, 0.15, 3e-3
CARD = "cuda"  # the training phases' device (a CPU rehearsal may set "cpu")
# Serving (phase 9): the bundle's buckets and batch, the request shapes
# (sampled from the real val manifest), the client concurrencies, and the
# largest program file as a share of params.pt (the weights are saved once).
SERVE_SHAPES, SERVE_BATCH = "448x608,608x448", 4
SERVE_REQUESTS = 16
SERVE_CONCURRENCY = (1, 4, 8, 16)
PROGRAM_SHARE = 0.05
# Data parallel on one card (phase 10). (a): two gloo ranks on cuda:0, one
# image each, rank 1's canvas padded to rank 0's; the flagship in float32,
# TF32 off, dropout on (the ranks draw one process's masks), against one
# process on the same card with the joined batch of 2. The limits are phase
# 8's card-vs-CPU ones (LOSS_REL, GRAD_REL, STAT_REL; measured there on an
# H100: BN statistics 1.5e-3, gradients 3.3e-2 / 4.9e-2): the two runs
# differ only in how a batch of 1 and one of 2 round (per-rank sums added
# across ranks, cuDNN's choices per batch size), less than a card against a
# CPU. The accuracy within DP_ACC: a few near-tied argmaxes of ~7,000
# labelled pixels may flip. BN's iter must be equal, and both ranks' state
# equal bit for bit. (c): the batched two-engine run sets ``cli.eval.CHUNK``
# to DP_EVAL_CHUNK images (the CLI's 32 would hand all 9 to one engine), so
# that both engines get some of them.
# Per rank: (H, W), void share; (a) takes the first two, the multi-card
# check one per card.
DP_IMAGES = [((448, 608), 0.1), ((384, 608), 0.4), ((448, 576), 0.2), ((416, 608), 0.0),
             ((384, 576), 0.3), ((448, 544), 0.1), ((352, 608), 0.5), ((448, 608), 0.0)]
DP_TIMED_STEPS = 3
DP_ACC = 1e-3
DP_GRADS = ("encoder.layer4.2.conv3.weight", "decoder.ppm.0.1.weight",
            "decoder.conv_last.4.weight")
DP_EVAL_CHUNK = 4
BUCKETED_MIOU = 1e-4  # PARITY.md's bar for the bucketed and packed paths


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def _tolerance(dtype):
    import torch

    # f32: summation order only. bf16: each side rounds its f32 mean once,
    # so they may differ by one bf16 ulp (2^-7 relative).
    return dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=0.0, rtol=8e-3)


def _valid_tolerance(dtype):
    # The pad-aware plain version sums in another order (two einsums over
    # bin matrices). Where a bf16 mean cancels to nearly 0, the f32
    # summation-order difference (seen: 5.7e-9 against a mean of the same
    # size) survives the rounding and its relative error is unbounded, so
    # bf16 also takes the f32 atol.
    return dict(_tolerance(dtype), atol=1e-5)


def _check_one(ppm_pool, torch, x, valid_hw, tolerance) -> float:
    """Kernel against plain version on ``x``; two launches must agree bit
    for bit. Returns the largest absolute difference."""
    outs = ppm_pool.pyramid_pool(x, valid_hw=valid_hw)
    again = ppm_pool.pyramid_pool(x, valid_hw=valid_hw)
    refs = ppm_pool.pyramid_pool_plain(x, valid_hw=valid_hw)
    err = 0.0
    for o, o2, r in zip(outs, again, refs):
        if not torch.equal(o, o2):
            raise RuntimeError(f"pyramid_pool {tuple(x.shape)}: two launches differ")
        torch.testing.assert_close(o.float(), r.float(), **tolerance)
        err = max(err, (o.float() - r.float()).abs().max().item())
    return err


def check_kernel(ppm_pool, torch) -> float:
    max_err = 0.0
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape, dt in CHECK_SHAPES:
        dtype = getattr(torch, dt)
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        max_err = max(max_err, _check_one(ppm_pool, torch, x, None, _tolerance(dtype)))
        print(f"[check] pyramid_pool {shape} {dt}: ok, two launches bit-equal", flush=True)
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        numel = UNALIGNED_SHAPE[0] * UNALIGNED_SHAPE[1] * UNALIGNED_SHAPE[2] * UNALIGNED_SHAPE[3]
        x = torch.randn(numel + 1, generator=g, device="cuda").to(dtype)[1:].view(UNALIGNED_SHAPE)
        if x.data_ptr() % 16 == 0:
            raise RuntimeError("the unaligned check's map is 16-byte aligned")
        max_err = max(max_err, _check_one(ppm_pool, torch, x, None, _tolerance(dtype)))
        print(f"[check] pyramid_pool {UNALIGNED_SHAPE} {dt}, data_ptr % 16 = "
              f"{x.data_ptr() % 16}: ok, two launches bit-equal", flush=True)
    torch.cuda.synchronize()
    return max_err


def check_valid_kernel(ppm_pool, torch) -> float:
    max_err = 0.0
    g = torch.Generator(device="cuda").manual_seed(1)
    for shape, extents in VALID_CHECKS:
        v = torch.tensor(extents, dtype=torch.int32, device="cuda")
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            x = torch.randn(shape, generator=g, device="cuda").to(dtype)
            max_err = max(max_err, _check_one(ppm_pool, torch, x, v, _valid_tolerance(dtype)))
            print(f"[check] pyramid_pool valid_hw {shape} {dt} extents {extents}: ok, "
                  f"two launches bit-equal", flush=True)
    torch.cuda.synchronize()
    return max_err


def _median_ms(fn, torch, flush=None) -> float:
    """Median of 50 timed calls after 10 warm-ups. With ``flush`` (a 256 MB
    float32 tensor) the buffer is read before each call, outside the
    events, so the L2 holds none of the call's inputs (cold)."""
    for _ in range(10):
        fn()
    times = []
    for _ in range(50):
        if flush is not None:
            flush.sum()
        # Keep the card busy while the host enqueues, so each pair of events
        # brackets device time only.
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def bound_ms(shape, extents, element_size):
    """Least time for one call on an H100 SXM, and what sets it: the bytes
    it must move (the valid region of the map read once, 50 means per
    channel written once, the extents) over 3.35 TB/s, against about one
    f32 add per element read at 67 TFLOP/s."""
    n, h, w, c = shape
    pixels = n * h * w if extents is None else sum(eh * ew for eh, ew in extents)
    moved = (pixels + 50 * n) * c * element_size + (0 if extents is None else 8 * n)
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = pixels * c / 67e12 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _matching(events, names, what):
    """The profiler events whose key holds one of ``names``. Raises if the
    profile holds device kernels but none of these (a renamed kernel must
    not pass a check empty); an empty list means that the profiler
    recorded no device activity at all."""
    from torch.autograd import DeviceType

    found = [e for e in events if any(name in e.key for name in names)]
    device = sorted({e.key[:80] for e in events if e.device_type == DeviceType.CUDA})
    if not found and device:
        raise RuntimeError(f"{what}: no kernel named {names} in the profile; kernels seen: "
                           f"{device[:20]}")
    return found


def _profiled(fn, torch, flush, calls=10, names=()):
    """key_averages() of ``calls`` cold calls of ``fn`` under torch.profiler,
    profiled again (up to five times) while it records no device activity
    or, with ``names``, fewer than ``calls`` kernels of those names (CUPTI
    sometimes drops a profile's kernels, or one kernel's record: three
    profiles in a row kept 9 of 10 band launches on an H100), or while its
    timeline disagrees with CUDA events around the same calls: the span
    from the spin kernel's end (the start event) to the last kernel's end
    must be within 3% of the events' (on an H100 a profile now and then
    reads every kernel and every gap between them at 0.5-0.8x, while the
    events do not move). Raises if five profiles in a row disagree."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # Keep the card busy (~10 ms) while the host enqueues every call
            # and the end event, so that no host delay lies between them.
            torch.cuda._sleep(20_000_000)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                flush.sum()
                fn()
            end.record()
            torch.cuda.synchronize()
        events = prof.key_averages()
        named = sum(e.count for e in events if any(n in e.key for n in names))
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        ranges = [e.time_range for e in device if "spin_kernel" not in e.name]
        if not ranges:
            continue
        spin = [e.time_range.end for e in device if "spin_kernel" in e.name]
        span = max(r.end for r in ranges) - (spin[0] if spin else min(r.start for r in ranges))
        timed = start.elapsed_time(end) * 1e3
        if abs(span / timed - 1) <= 0.03:
            if named >= calls * bool(names):
                break
        else:
            print(f"[profile] the profile's span {span:.2f} us against the events' {timed:.2f} "
                  "us: profiled again", flush=True)
    else:
        if ranges and abs(span / timed - 1) > 0.03:
            raise RuntimeError(f"five profiles in a row disagree with the events (last: span "
                               f"{span:.2f} us against {timed:.2f} us)")
    return events


def _pass_us(ppm_pool, torch, x, v, flush):
    """Mean device time (us) of each of the kernel's two passes over 10
    cold calls, from torch.profiler (empty: not measured)."""
    events = _profiled(lambda: ppm_pool.launch(ppm_pool._lib(), x, v), torch, flush)
    found = _matching(events, FORWARD_KERNELS, f"pyramid_pool {tuple(x.shape)}")
    return {name: e.self_device_time_total / e.count
            for e in found for name in FORWARD_KERNELS if name in e.key}


def time_kernel(ppm_pool, torch, card: str, compare=None) -> dict:
    """Phase 4: per timed case and dtype, (kernel ms warm, cold, plain ms,
    bound ms, bound_by)."""
    import torch.nn.functional as F

    flush = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    this = ppm_pool._lib()
    tiny = torch.zeros(1, device="cuda")
    floor = _median_ms(tiny.zero_, torch)
    print(f"[time] context: a one-element fill between the same events takes {floor:.4f} ms "
          f"(the launch-and-event floor of every time below; card: {card})", flush=True)
    out = {}
    for name, shape, extents in TIME_CASES:
        v = None if extents is None else torch.tensor(extents, dtype=torch.int32, device="cuda")
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            x = torch.randn(shape, device="cuda").to(dtype)
            warm = _median_ms(lambda: ppm_pool.pyramid_pool(x, valid_hw=v), torch)
            cold = _median_ms(lambda: ppm_pool.pyramid_pool(x, valid_hw=v), torch, flush)
            plain = _median_ms(lambda: ppm_pool.pyramid_pool_plain(x, valid_hw=v), torch)
            bound, bound_by = bound_ms(shape, extents, x.element_size())
            passes = _pass_us(ppm_pool, torch, x, v, flush)
            out[(name, shape, dt)] = (warm, cold, plain, bound, bound_by)
            form = "dense" if v is None else f"valid_hw {'mixed' if len(set(map(tuple, extents))) > 1 else 'full'} extents"
            print(f"[time] pyramid_pool {form} {shape} {dt}: kernel {warm:.4f} ms warm, "
                  f"{cold:.4f} ms cold; bound {bound:.4f} ms ({bound_by}), share of bound "
                  f"{bound / cold:.3f} cold, {bound / warm:.3f} warm; passes under the profiler "
                  f"(cold, us; pass 2 starts early and waits for pass 1): " + ", ".join(f"{k} {t:.2f}" for k, t in passes.items()) +
                  f"; plain {plain:.4f} ms (median of 50; card: {card})", flush=True)
            if v is None:
                # No single PyTorch call computes the four grids; the closest
                # arrangement, as context only: an NCHW f32 copy and four pools.
                def four_pools():
                    xn = x.permute(0, 3, 1, 2).contiguous().float()
                    return [F.adaptive_avg_pool2d(xn, s) for s in ppm_pool.SCALES]
                lib_ms = _median_ms(four_pools, torch, flush)
                sum_ms = _median_ms(lambda: x.sum(dtype=torch.float32), torch, flush)
                print(f"[time] context, no single PyTorch call: NCHW f32 copy + four "
                      f"F.adaptive_avg_pool2d {shape} {dt}: {lib_ms:.4f} ms cold; one read of "
                      f"the same bytes by torch.sum: {sum_ms:.4f} ms cold", flush=True)
            if compare is not None:
                _turns(lambda lb: lambda: ppm_pool.launch(lb, x, v),
                       {"this": this, "other": compare}, torch, flush, card,
                       f"{form} {shape} {dt}")
    return out


def print_build(kernels_module, name="ppm_pool"):
    """Registers and spills of every kernel of library ``name`` (built from
    ``kernels_module.SOURCES``) from the build's ptxas output; raises,
    after printing them all, if any spills."""
    from semseg_tpu_torch.ops.kernels._build import build_log

    log = build_log(name, kernels_module.SOURCES)
    kernel, spills, kernels, spilled = None, None, 0, []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel, spills = m.group(1), None
            continue
        if "spill stores" in line:
            spills = [int(b) for b in re.findall(r"(\d+) bytes spill", line)]
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            if spills is None:
                raise RuntimeError(f"no spill line in the ptxas output for {kernel}")
            kernels += 1
            short = re.sub(rf"^_ZN\w*?_{name}_cu_\w{{8}}\d+", "", kernel)[:60]
            smem = re.search(r"(\d+) bytes smem", line)
            print(f"[build] ptxas: {short}: {m.group(1)} registers, "
                  f"{smem.group(1) if smem else 0} bytes shared memory, spill stores/loads "
                  f"{spills[0]}/{spills[1]} bytes", flush=True)
            if any(spills):
                spilled.append((short, spills))
            kernel = None
    if kernels == 0:
        raise RuntimeError("the build log holds no ptxas report")
    if spilled:
        raise RuntimeError(f"kernels spill registers: {spilled}")


# The BN kernel (``ops/kernels/bn_act.py``): the flagship's eval maps, each
# (shape, residual, act); then odd C and the PPM's 1x1 grids.
BN_ACT_KERNEL = "bn_act_"  # bn_act_nhwc_kernel
BN_ACT_TIMED = [((8, 2048, 75, 100), True, "relu"),  # a block's last BN
                ((8, 256, 150, 200), False, "relu"),  # layer1's bn1 / bn2
                ((8, 512, 75, 100), False, None)]  # the PPM's last ConvBN before ReLU
BN_ACT_CHECKS = BN_ACT_TIMED + [((8, 64, 300, 400), False, "relu"),
                                ((2, 36, 17, 23), True, "relu6"),
                                ((8, 2048, 1, 1), False, "relu")]
# Under a gradient (``TRAIN.fix_bn``): the kernel forward, the operator's
# backward.
BN_ACT_GRAD_CHECKS = [((2, 256, 38, 50), True, "relu"), ((2, 36, 17, 23), False, "relu6")]
BN_ACT_HOST_CALLS = 2000  # per timing, after 200 warm-ups; median of 5


def _bn_params(torch, c, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(c, generator=g, device="cuda") * 1.5,
            torch.randn(c, generator=g, device="cuda"),
            torch.randn(c, generator=g, device="cuda") * 0.5,
            torch.rand(c, generator=g, device="cuda") * 2 + 0.05]


def check_bn_act(bn_act, torch):
    """The kernel ``torch.equal`` to its plain version (the parent's chain
    of ops) at the flagship's maps and the other paths, bf16 and f32; two
    launches bit-equal; every call counted as a launch. Under a gradient
    the kernel forward, and the operator's backward equal to autograd's
    through the plain chain. NCHW and float64 maps refused. Returns the
    cases checked and the largest |kernel - plain| over them."""
    g = torch.Generator(device="cuda").manual_seed(11)
    checked, max_err = 0, 0.0

    def leaves(shape, dtype, residual, grad=False):
        x = (torch.randn(shape, generator=g, device="cuda") * 3).to(dtype).contiguous(
            memory_format=torch.channels_last)
        r = None if not residual else torch.randn(
            shape, generator=g, device="cuda").to(dtype).contiguous(
            memory_format=torch.channels_last)
        params = _bn_params(torch, shape[1], checked)
        if grad:
            x.requires_grad_()
            params[0].requires_grad_()
            params[1].requires_grad_()
            if r is not None:
                r.requires_grad_()
        return x, params, r

    def err(a, b):
        return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0

    for shape, residual, act in BN_ACT_CHECKS:
        for dt in ("bfloat16", "float32"):
            x, params, r = leaves(shape, getattr(torch, dt), residual)
            before = bn_act.LAUNCHES
            with torch.inference_mode():
                got = bn_act.bn_act(x, *params, 1e-5, r, act)
                again = bn_act.bn_act(x, *params, 1e-5, r, act)
                want = bn_act.bn_act_plain(x, *params, 1e-5, r, act)
            torch.cuda.synchronize()
            if bn_act.LAUNCHES != before + 2:
                raise RuntimeError(f"bn_act {shape}: {bn_act.LAUNCHES - before} launches "
                                   "counted for 2 calls")
            if not torch.equal(got, again):
                raise RuntimeError(f"bn_act {shape} {dt}: two launches differ")
            max_err = max(max_err, err(got, want))
            if not torch.equal(got, want):
                diff = (got.float() - want.float()).abs()
                raise RuntimeError(f"bn_act {shape} {dt} residual={residual} act={act}: "
                                   f"{int((diff > 0).sum())} elements differ from the plain "
                                   f"chain, largest {diff.max().item()}")
            checked += 1
            print(f"[bn_act] check {shape} {dt} residual={residual} act={act}: torch.equal "
                  "to the plain chain, two launches bit-equal", flush=True)
    for shape, residual, act in BN_ACT_GRAD_CHECKS:
        for dt in ("bfloat16", "float32"):
            x, params, r = leaves(shape, getattr(torch, dt), residual, grad=True)
            inputs = [t for t in (x, params[0], params[1], r) if t is not None]
            before = bn_act.LAUNCHES
            got = bn_act.bn_act(x, *params, 1e-5, r, act)
            torch.cuda.synchronize()
            if bn_act.LAUNCHES != before + 1:
                raise RuntimeError(f"bn_act {shape} under a gradient: "
                                   f"{bn_act.LAUNCHES - before} launches")
            dy = torch.randn(got.shape, generator=g, device="cuda").to(got.dtype)
            got = [got.detach(), *torch.autograd.grad(got, inputs, dy)]
            want = bn_act.bn_act_plain(x, *params, 1e-5, r, act)
            want = [want.detach(), *torch.autograd.grad(want, inputs, dy)]
            for what, a, b in zip(("output", "x", "weight", "bias", "residual"), got, want):
                max_err = max(max_err, err(a, b))
                if not torch.equal(a, b):
                    raise RuntimeError(f"bn_act {shape} {dt} residual={residual} act={act} "
                                       f"under a gradient: the {what} differs from the plain "
                                       f"chain's by up to {err(a, b)}")
            checked += 1
            print(f"[bn_act] check {shape} {dt} residual={residual} act={act} under a "
                  "gradient: one launch, the output and the gradients of the map, the affine "
                  "and the residual torch.equal to autograd's through the plain chain",
                  flush=True)
    params = _bn_params(torch, 16, 0)
    for what, x in (("NCHW", torch.zeros(2, 16, 3, 4, device="cuda")),
                    ("float64", torch.zeros(2, 16, 3, 4, device="cuda", dtype=torch.float64)
                     .contiguous(memory_format=torch.channels_last))):
        try:
            bn_act.bn_act(x, *params, 1e-5, None, "relu")
        except ValueError:
            print(f"[bn_act] {what} map on the card: refused (ValueError)", flush=True)
        else:
            raise RuntimeError(f"bn_act took a {what} map on the card")
    return checked, max_err


def bn_act_bound_ms(shape, residual, element_size):
    """Least time on an H100 SXM: the map (and the residual) read once and
    the output written once, over 3.35 TB/s (a few operations an element:
    far below the ridge)."""
    n, c, h, w = shape
    return (3 if residual else 2) * n * c * h * w * element_size / HBM_BYTES_PER_S * 1e3


def time_bn_act(bn_act, torch, card) -> dict:
    """Per timed case and dtype: (kernel ms warm, cold, plain ms cold,
    bound ms, device us)."""
    flush = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    out = {}
    for shape, residual, act in BN_ACT_TIMED:
        params = _bn_params(torch, shape[1], 0)
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            x = torch.randn(shape, device="cuda").to(dtype).contiguous(
                memory_format=torch.channels_last)
            r = torch.randn_like(x) if residual else None
            with torch.inference_mode():
                def kernel():
                    return bn_act.bn_act(x, *params, 1e-5, r, act)

                def plain():
                    return bn_act.bn_act_plain(x, *params, 1e-5, r, act)

                warm = _median_ms(kernel, torch)
                cold = _median_ms(kernel, torch, flush)
                plain_cold = _median_ms(plain, torch, flush)
                device = _device_us(kernel, torch, flush, (BN_ACT_KERNEL,),
                                    f"bn_act {shape} {dt}")
            bound = bn_act_bound_ms(shape, residual, x.element_size())
            out[(shape, dt)] = (warm, cold, plain_cold, bound, device)
            print(f"[bn_act] time {shape} {dt} residual={residual} act={act}: kernel "
                  f"{warm:.4f} ms warm, {cold:.4f} ms cold, device {_us(device)} cold; bound "
                  f"{bound:.4f} ms (bytes read once and written once), share of bound "
                  f"{bound / cold:.3f} cold, {bound / warm:.3f} warm"
                  + ("" if device is None else f", {bound * 1e3 / device:.3f} device")
                  + f"; plain chain {plain_cold:.4f} ms cold (median of 50; card: {card})",
                  flush=True)
            del x, r
    return out


def bn_act_host_us(bn_act, torch, card) -> dict:
    """Host time (us) of one eval BN call with tracing off, on a small map
    (the card keeps pace): the module with the kernel, the parent's module
    (the plain chain: four ``.to(device)`` of its parameters, the affine
    rebuilt, two casts, then ``F.relu``, in the same span), and, without
    the module, the wrapper's direct launch and the registered operator
    through the dispatcher; without and with a residual. Median of 5 rounds, each timing ``BN_ACT_HOST_CALLS`` calls of
    every form in turn (the host's speed drifts within a call)."""
    import torch.nn.functional as F

    from semseg_tpu_torch.models.layers import BatchNorm2d
    from semseg_tpu_torch.ops.norm import batch_norm_inference
    from semseg_tpu_torch.utils.spans import span

    bn = BatchNorm2d(64).to("cuda").eval()
    x = torch.randn(1, 64, 8, 8, device="cuda").to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    r = torch.randn_like(x)

    def parent(x, residual=None):
        with span("semseg::bn"):
            y = batch_norm_inference(x, *(t.to(x.device, non_blocking=True) for t in (
                bn.weight, bn.bias, bn.running_mean, bn.running_var)), eps=bn.eps)
        return F.relu(y if residual is None else y + residual)

    params = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    calls = {
        "change": lambda: bn(x, act="relu"),
        "parent": lambda: parent(x),
        "direct": lambda: bn_act.bn_act(x, *params, bn.eps, None, "relu"),
        "operator": lambda: torch.ops.semseg_tpu_torch.bn_act(x, *params, bn.eps, None, "relu"),
        "change+residual": lambda: bn(x, act="relu", residual=r),
        "parent+residual": lambda: parent(x, r),
    }
    runs = {name: [] for name in calls}
    with torch.inference_mode():
        for fn in calls.values():
            for _ in range(200):
                fn()
        torch.cuda.synchronize()
        for _ in range(5):
            for name, fn in calls.items():
                tic = time.perf_counter()
                for _ in range(BN_ACT_HOST_CALLS):
                    fn()
                runs[name].append((time.perf_counter() - tic) / BN_ACT_HOST_CALLS * 1e6)
                torch.cuda.synchronize()
    out = {name: sorted(r)[2] for name, r in runs.items()}
    print("[bn_act] host time of one eval BN call, tracing off (us, median of 5 rounds of "
          f"{BN_ACT_HOST_CALLS}): " + ", ".join(f"{k} {v:.2f}" for k, v in out.items())
          + f" (card: {card})", flush=True)
    return out


def bn_act_phase(torch, card) -> dict:
    """The BN kernel: built (registers, spills), checked, timed, and one
    BN call's host time."""
    from semseg_tpu_torch.ops.kernels import bn_act

    tic = time.perf_counter()
    bn_act._lib()
    print(f"[build] bn_act.cu built/loaded in {time.perf_counter() - tic:.2f} s", flush=True)
    print_build(bn_act, "bn_act")
    checked, max_err = check_bn_act(bn_act, torch)
    times = time_bn_act(bn_act, torch, card)
    host = bn_act_host_us(bn_act, torch, card)
    return dict(checked=checked, max_err=max_err, times=times, host=host)


def _write_images(root, shapes, rng, labels=False):
    from PIL import Image
    import numpy as np

    records = []
    for i, (h, w) in enumerate(shapes):
        # Smooth colour gradients plus noise: JPEG-friendly, not constant.
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (h + w)], -1)
        img = np.clip(base + rng.randint(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, f"img{i}.jpg"), quality=95)
        rec = {"fpath_img": f"img{i}.jpg", "height": h, "width": w}
        if labels:
            seg = rng.randint(0, 151, (h, w)).astype(np.uint8)
            Image.fromarray(seg, mode="L").save(os.path.join(root, f"seg{i}.png"))
            rec["fpath_segm"] = f"seg{i}.png"
        records.append(rec)
    return records


def _write_val_set(root, shapes, seed):
    import numpy as np

    os.makedirs(root)
    records = _write_images(root, shapes, np.random.RandomState(seed), labels=True)
    odgt = os.path.join(root, "val.odgt")
    with open(odgt, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in records)
    return odgt


def _cfg(*opts, path=CFG):
    from semseg_tpu_torch.config import cfg as default_cfg

    cfg = default_cfg.clone()
    cfg.merge_from_file(path)
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg


def _val_items(cfg, val_dir, odgt):
    """(pyramids, labels) of a val set as the default eval CLI loads them."""
    from semseg_tpu_torch.data import ValDataset

    ds = ValDataset(val_dir, odgt, cfg.DATASET, device_preprocess=True,
                    bucket_step=cfg.TPU.eval_bucket_step)
    items = [ds[i] for i in range(len(ds))]
    return [it["img_data"] for it in items], [it["seg_label"][0] for it in items]


def _plan_engine(cls, cfg, batch=4, **kw):
    """An engine without a model, on the CPU, set up as ``build_engines``
    sets up the eval CLI's, to count the chunks it schedules."""
    from semseg_tpu_torch.data.dataset import _effective_lattice
    from semseg_tpu_torch.engine import output_stride_for

    return cls(None, device="cpu", num_class=cfg.DATASET.num_class,
               output_stride=output_stride_for(cfg),
               bucket_step=_effective_lattice(cfg.TPU.eval_bucket_step,
                                              cfg.DATASET.padding_constant),
               padding_constant=cfg.DATASET.padding_constant, batch_size=batch,
               pack_buckets=True, **kw)


def expected_chunks(cfg, val_dir, odgt, batch=4, *, flagship=True, calls=32):
    """Chunks the batched engine schedules for the val set, handed to it in
    calls of ``calls`` images (the eval CLI's 32), counted from its own
    schedule."""
    from semseg_tpu_torch.engine import BatchedInferenceEngine

    all_pyrs, all_labels = _val_items(cfg, val_dir, odgt)
    eng = _plan_engine(BatchedInferenceEngine, cfg, batch)
    chunks = 0
    for lo in range(0, len(all_pyrs), calls):
        pyrs, labels = all_pyrs[lo:lo + calls], all_labels[lo:lo + calls]
        windows = eng._canvas_windows([lab.shape for lab in labels], range(len(pyrs)))
        for window in windows:
            groups = eng._group_by_bucket([pyrs[i] if i in window else []
                                           for i in range(len(pyrs))])
            fill = sorted((k, len(t), len({x[0] for x in t})) for k, t in groups.items())
            folded = sum(eng._bucket_key(h, w) != k for k, t in groups.items()
                         for *_, h, w in t)
            if flagship:
                print(f"[main] window of {len(window)} images: buckets (key, tasks, images) "
                      f"{fill}; {folded} tasks packed into a larger bucket", flush=True)
                shared = [f for f in fill if f[2] > 1]
                padded = [f for f in fill if f[1] % batch]
                if not shared or not padded:
                    raise RuntimeError("the eval images must share a bucket and pad a last "
                                       "chunk")
            chunks += len(eng._schedule(groups))
    return chunks


def expected_dp_chunks(cfg, shapes, batch=4, *, quiet=False):
    """Chunks the device-pyramid engine schedules for originals of these
    (H, W) shapes: its windows, ``level_plan`` and ``_pack_groups``."""
    from semseg_tpu_torch.engine import DevicePyramidEngine

    eng = _plan_engine(DevicePyramidEngine, cfg, batch, img_sizes=cfg.DATASET.imgSizes,
                       img_max_size=cfg.DATASET.imgMaxSize)
    plans = [eng.level_plan(h, w) for h, w in shapes]
    chunks = 0
    for window in eng._windows(shapes):
        groups = eng._level_groups(window, plans)
        chunks += len(eng._schedule(groups))
        if not quiet:
            fill = sorted((k, len(t)) for k, t in groups.items())
            print(f"[main] device-pyramid window of {len(window)} images (batch {batch}): "
                  f"buckets (key, tasks) {fill}", flush=True)
    return chunks


def _run_path(name, fn, ppm_pool, torch, backward=0, band=0, band_backward=0):
    """Drive one path with the launch counts set to 0; returns (result,
    seconds, dense launches, valid launches). The backward kernel must
    launch ``backward`` times, the band form ``band`` times, the band
    backward ``band_backward`` times."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ppm_pool.LAUNCHES = 0
    ppm_pool.VALID_LAUNCHES = 0
    ppm_pool.BAND_LAUNCHES = 0
    ppm_pool.BACKWARD_LAUNCHES = 0
    ppm_pool.BAND_BACKWARD_LAUNCHES = 0
    tic = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - tic
    dense, valid = ppm_pool.LAUNCHES, ppm_pool.VALID_LAUNCHES
    print(f"[main] {name}: pyramid_pool launches dense {dense}, valid_hw {valid}, backward "
          f"{ppm_pool.BACKWARD_LAUNCHES}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if (ppm_pool.BACKWARD_LAUNCHES, ppm_pool.BAND_LAUNCHES,
            ppm_pool.BAND_BACKWARD_LAUNCHES) != (backward, band, band_backward):
        raise RuntimeError(f"{name}: {ppm_pool.BACKWARD_LAUNCHES} backward launches "
                           f"(expected {backward}), {ppm_pool.BAND_LAUNCHES} band launches "
                           f"(expected {band}), {ppm_pool.BAND_BACKWARD_LAUNCHES} band "
                           f"backward launches (expected {band_backward})")
    return result, seconds, dense, valid


def main_path(work, torch, ppm_pool):
    import numpy as np

    from semseg_tpu_torch.cli import eval as eval_cli, test as test_cli
    from semseg_tpu_torch.models import ModelBuilder

    cfg = _cfg()
    n_scales = len(cfg.DATASET.imgSizes)
    ckpt = os.path.join(work, "ckpt")
    os.makedirs(ckpt)
    model = ModelBuilder.build_model(cfg, device="cpu", seed=0)
    for name, module in (("encoder", model.encoder), ("decoder", model.decoder)):
        torch.save(module.state_dict(), os.path.join(ckpt, f"{name}_epoch_20.pth"))
    del model

    test_dir = os.path.join(work, "test_imgs")
    out_dir = os.path.join(work, "result")
    os.makedirs(test_dir)
    _write_images(test_dir, TEST_IMAGES, np.random.RandomState(0))
    val_dir = os.path.join(work, "val")
    odgt = _write_val_set(val_dir, EVAL_IMAGES, seed=1)
    data = ["DATASET.root_dataset", val_dir, "DATASET.list_val", odgt]
    chunks = expected_chunks(cfg, val_dir, odgt)
    dp_chunks = expected_dp_chunks(cfg, EVAL_IMAGES)
    launches = {"dense": 0, "valid": 0}
    from semseg_tpu_torch.ops.kernels import bn_act

    bn_start = bn_act.LAUNCHES
    _, test_s, dense, valid = _run_path("cli.test", lambda: test_cli.main(
        ["--imgs", test_dir, "--cfg", CFG, "DIR", ckpt, "TEST.result", out_dir]),
        ppm_pool, torch)
    pngs = sorted(p for p in os.listdir(out_dir) if p.endswith(".png"))
    if len(pngs) != len(TEST_IMAGES):
        raise RuntimeError(f"test CLI wrote {pngs}, expected {len(TEST_IMAGES)} PNGs")
    if (dense, valid) != (0, len(TEST_IMAGES) * n_scales):
        raise RuntimeError(f"cli.test launched dense {dense} / valid {valid} times, "
                           f"expected 0 / {len(TEST_IMAGES) * n_scales}")
    launches["valid"] += valid
    print(f"[main] cli.test (bucketed per-image engine): {len(pngs)} PNGs, "
          f"{test_s / len(TEST_IMAGES):.3f} s/image wall (first run, cuDNN set-up "
          f"included)", flush=True)

    results = {}
    for name, flags, want in (
        ("cli.eval --exact", ["--exact"], (len(EVAL_IMAGES) * n_scales, 0)),
        ("cli.eval", [], (0, chunks)),
        ("cli.eval --device-pyramid", ["--device-pyramid"], (0, dp_chunks)),
    ):
        bn_before = bn_act.LAUNCHES
        (miou, acc, _, raw), wall_s, dense, valid = _run_path(name, lambda: eval_cli.main(
            ["--cfg", CFG, *flags, "DIR", ckpt, *data]), ppm_pool, torch)
        bn_launches = bn_act.LAUNCHES - bn_before
        if bn_launches == 0:
            raise RuntimeError(f"{name}: no BN kernel launch")
        print(f"[main] {name}: {bn_launches} BN kernel launches", flush=True)
        if (dense, valid) != want:
            raise RuntimeError(f"{name} launched dense {dense} / valid {valid} times, "
                               f"expected {want[0]} / {want[1]}")
        if not (np.isfinite(miou) and 0.0 <= miou <= 1.0 and 0.0 <= acc <= 1.0):
            raise RuntimeError(f"{name}: metrics out of range: mIoU {miou}, acc {acc}")
        launches["dense"] += dense
        launches["valid"] += valid
        results[name] = raw
        if valid:
            print(f"[main] {name}: {valid} valid_hw launches = {want[1]} chunks scheduled "
                  f"(batch 4, packed)", flush=True)
        print(f"[main] {name}: mIoU {miou:.4f}, accuracy {acc * 100:.2f}% (random weights), "
              f"{wall_s / len(EVAL_IMAGES):.4f} s/image wall (first run, model build and "
              f"cuDNN set-up included), {raw['seconds_per_image']:.4f} s/image in the engine",
              flush=True)
    pix = {name: raw["pix_count"] for name, raw in results.items()}
    if len(set(pix.values())) != 1:
        raise RuntimeError(f"the eval paths counted different labelled pixels: {pix}")
    print(f"[main] all three eval paths counted {pix['cli.eval']:.0f} labelled pixels", flush=True)
    launches["bn"] = bn_act.LAUNCHES - bn_start
    return ckpt, val_dir, odgt, launches


def _save_random_pth(cfg, ckpt, torch):
    """A seeded random model of ``cfg`` saved as a reference-format .pth
    pair under ``ckpt``, named as cfg.VAL.checkpoint resolves it."""
    from semseg_tpu_torch.models import ModelBuilder

    os.makedirs(ckpt, exist_ok=True)
    model = ModelBuilder.build_model(cfg, device="cpu", seed=0)
    for name, module in (("encoder", model.encoder), ("decoder", model.decoder)):
        torch.save(module.state_dict(), os.path.join(ckpt, f"{name}_{cfg.VAL.checkpoint}"))


def zoo_phase(work, torch, ppm_pool):
    """Every other shipped config through the default ``cli.eval`` (3
    labelled images) and ``cli.test`` (1 image), full width, its own scales
    and lattice. The pad-aware pool runs once per scheduled chunk and per
    level in PPM and UPerNet configs, and never in C1 configs."""
    import numpy as np

    from semseg_tpu_torch.cli import eval as eval_cli, test as test_cli
    from semseg_tpu_torch.ops.kernels import bn_act

    val_dir = os.path.join(work, "zoo_val")
    odgt = _write_val_set(val_dir, ZOO_IMAGES, seed=4)
    test_dir = os.path.join(work, "zoo_test")
    os.makedirs(test_dir)
    _write_images(test_dir, ZOO_IMAGES[:1], np.random.RandomState(5))
    data = ["DATASET.root_dataset", val_dir, "DATASET.list_val", odgt]
    launches, ckpts = {"dense": 0, "valid": 0}, {}
    bn_total = bn_act.LAUNCHES
    for name in ZOO_CONFIGS:
        path = os.path.join(HERE, "config", name)
        cfg = _cfg(path=path)
        ckpt = os.path.join(work, "zoo_ckpt", name[:-5])
        tic = time.perf_counter()
        _save_random_pth(cfg, ckpt, torch)
        save_s = time.perf_counter() - tic
        ckpts[name] = ckpt
        pooled = cfg.MODEL.arch_decoder in POOLED_DECODERS
        n_scales = len(cfg.DATASET.imgSizes)
        want_eval = (0, expected_chunks(cfg, val_dir, odgt, flagship=False) if pooled else 0)
        want_test = (0, n_scales if pooled else 0)
        tag = f"{cfg.MODEL.arch_encoder} + {cfg.MODEL.arch_decoder}"
        bn_start = bn_act.LAUNCHES
        (miou, acc, _, raw), eval_s, dense, valid = _run_path(
            f"zoo {tag}: cli.eval", lambda: eval_cli.main(
                ["--cfg", path, "DIR", ckpt, *data]), ppm_pool, torch)
        if bn_act.LAUNCHES == bn_start:
            raise RuntimeError(f"{name} cli.eval: no BN kernel launch")
        if (dense, valid) != want_eval:
            raise RuntimeError(f"{name} cli.eval launched dense {dense} / valid {valid} times, "
                               f"expected {want_eval[0]} / {want_eval[1]}")
        if not (np.isfinite(miou) and 0.0 <= miou <= 1.0 and 0.0 <= acc <= 1.0
                and raw["pix_count"] > 0):
            raise RuntimeError(f"{name}: metrics out of range: mIoU {miou}, acc {acc}")
        launches["valid"] += valid
        out_dir = os.path.join(work, "zoo_result", name[:-5])
        _, test_s, dense, valid = _run_path(f"zoo {tag}: cli.test", lambda: test_cli.main(
            ["--imgs", test_dir, "--cfg", path, "DIR", ckpt, "TEST.checkpoint",
             cfg.VAL.checkpoint, "TEST.result", out_dir]), ppm_pool, torch)
        if (dense, valid) != want_test:
            raise RuntimeError(f"{name} cli.test launched dense {dense} / valid {valid} times, "
                               f"expected {want_test[0]} / {want_test[1]}")
        if len([p for p in os.listdir(out_dir) if p.endswith(".png")]) != 1:
            raise RuntimeError(f"{name}: cli.test wrote no PNG")
        launches["valid"] += valid
        print(f"[zoo] {tag} ({name}, padding_constant {cfg.DATASET.padding_constant}, output "
              f"stride {cfg.DATASET.segm_downsampling_rate}, {n_scales} scales): cli.eval "
              f"{raw['pix_count']:.0f} labelled pixels, mIoU {miou:.4f}, pool launches "
              f"{want_eval[1]} (= chunks scheduled); cli.test pool launches {want_test[1]}; wall "
              f"{eval_s:.1f} s eval + {test_s:.1f} s test (first runs, model build included), "
              f"{save_s:.1f} s to build and save the random .pth pair", flush=True)
    launches["bn"] = bn_act.LAUNCHES - bn_total
    return launches, ckpts


def _median_pass(fn, torch, n_images):
    """Seconds per image: median of 3 synchronised passes after a warm-up."""
    fn()
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - tic) / n_images)
    return sorted(runs)[1]


def steady_state(ckpt, val_dir, odgt, torch, card):
    """Seconds per image of the engines once cuDNN has seen the shapes: the
    batched (batch 4) and exact engines as the CLIs run them, then at
    bench.py's headline settings (batch 8, packed, step 8) the
    device-pyramid engine beside the batched engine; a profile of one
    batched and one device-pyramid pass."""
    from semseg_tpu_torch.data import PyramidBuilder, ValDataset
    from semseg_tpu_torch.checkpoint import resolve_reference_checkpoint
    from semseg_tpu_torch.cli.eval import build_engines

    cfg = _cfg("DIR", ckpt)
    resolve_reference_checkpoint(cfg, cfg.VAL.checkpoint)
    pyrs, labels = _val_items(cfg, val_dir, odgt)
    batched = build_engines(cfg, 1, batch=4, fetch_dtype="bfloat16", pack_buckets=True,
                            device="cuda")[0]
    exact = build_engines(cfg, 1, exact=True, device="cuda")[0]
    ds = ValDataset(val_dir, odgt, cfg.DATASET)
    host_pyrs = [ds[i]["img_data"] for i in range(len(ds))]
    oris = [ds[i]["img_ori"] for i in range(len(ds))]
    batched8 = build_engines(cfg, 1, batch=8, fetch_dtype="bfloat16", pack_buckets=True,
                             device="cuda")[0]
    dp8 = build_engines(cfg, 1, batch=8, fetch_dtype="bfloat16", pack_buckets=True,
                        device_pyramid=True, device="cuda")[0]

    def run_exact():
        for pyr, lab in zip(host_pyrs, labels):
            exact.predict(pyr, lab.shape)

    runs = {
        "batched": lambda: batched.batched_metrics(pyrs, labels),
        "exact": run_exact,
        "batched, batch 8": lambda: batched8.batched_metrics(pyrs, labels),
        "device-pyramid, batch 8": lambda: dp8.batched_metrics_from_originals(oris, labels),
    }
    times = {}
    for name, fn in runs.items():
        times[name] = _median_pass(fn, torch, len(pyrs))
        print(f"[steady] {name} engine: {times[name]:.4f} s/image (median of 3 passes over "
              f"{len(pyrs)} images, 5 scales, bf16, packed, step 8; card: {card})", flush=True)
    n_tasks = sum(len(p) for p in pyrs)
    for name, chunks in (("batched", expected_chunks(cfg, val_dir, odgt, 8, flagship=False)),
                         ("device-pyramid", expected_dp_chunks(cfg, EVAL_IMAGES, 8, quiet=True))):
        print(f"[steady] {name} engine at batch 8: {chunks} chunks, {chunks * 8} slots for "
              f"{n_tasks} level tasks ({1 - n_tasks / (chunks * 8):.2f} of the slots repeat a "
              f"task to fill a bucket's last chunk)", flush=True)
    # The batched engines take host pyramids the loader built beforehand;
    # the device-pyramid engine builds its levels inside its time.
    from semseg_tpu_torch.data.dataset import _native_ok

    builder = PyramidBuilder(cfg.DATASET, bucket_step=cfg.TPU.eval_bucket_step)
    tic = time.perf_counter()
    for ori in oris:
        builder.multi_scale_pyramid(ori, raw=True)
    host_s = (time.perf_counter() - tic) / len(oris)
    print(f"[steady] host {'native' if _native_ok() else 'PIL'} pyramid (5 uint8 levels on "
          f"the step-8 lattice; both paths: phase 11), one thread of "
          f"this machine's CPU: {host_s:.4f} s/image (outside the batched engines' times "
          f"above; the eval CLI builds it in 5 loader threads)", flush=True)
    for name, key in (("batched", "batched"), ("batched-8", "batched, batch 8"),
                      ("device-pyramid", "device-pyramid, batch 8")):
        busy_ms = profile_pass(name, runs[key], torch, card)
        if busy_ms:
            wall_ms = times[key] * len(pyrs) * 1e3
            print(f"[profile] {name} pass without the profiler: {wall_ms:.1f} ms wall, so "
                  f"device idle share about {max(0.0, 1 - busy_ms / wall_ms):.3f}", flush=True)
    return times


def profile_pass(name, fn, torch, card):
    """Device busy share, the pool's and the level derivation's device
    time, the top kernels and the top operators (by the device time of the
    kernels they launch) of one pass."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - tic) * 1e3
    events = prof.key_averages()
    os.makedirs(OUT_DIR, exist_ok=True)
    table = "chip_smoke_profile.txt" if name == "batched" else f"chip_smoke_profile_{name}.txt"
    with open(os.path.join(OUT_DIR, table), "w") as f:
        f.write(f"card: {card}\n")
        f.write(events.table(sort_by="self_device_time_total", row_limit=80, max_name_column_width=120))

    def dev_ms(e):
        return e.self_device_time_total / 1e3

    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    ops = [e for e in events if e.device_type == DeviceType.CPU and e.key.startswith("aten::")]
    busy_ms = sum(dev_ms(e) for e in kernels)
    if busy_ms <= 0:
        print(f"[profile] {name} pass: the profiler recorded no device time; "
              "device busy share not measured", flush=True)
        return
    print(f"[profile] {name} pass under torch.profiler: wall {wall_ms:.1f} ms, device "
          f"kernel time {busy_ms:.1f} ms, busy share {busy_ms / wall_ms:.3f} (card: {card})",
          flush=True)
    pool = _matching(kernels, FORWARD_KERNELS, f"the {name} pass")
    pool_ms = sum(dev_ms(e) for e in pool)
    print(f"[profile] pyramid_pool in the {name} pass: {pool_ms:.3f} ms of device time "
          f"({pool_ms / busy_ms:.2%}) over " + ", ".join(
              f"{e.count} x {next(k for k in FORWARD_KERNELS if k in e.key)}"
              for e in pool) + f" (card: {card})", flush=True)
    levels = [e for e in events if e.key == "semseg::levels" and e.device_type == DeviceType.CPU]
    if levels:
        # The kernels launched inside the engine's _levels range.
        lv_ms = sum(e.device_time_total for e in levels) / 1e3
        print(f"[profile] level derivation (semseg::levels: resize matrices, two f32 "
              f"products, normalize, mask) in the {name} pass: {lv_ms:.3f} ms of device "
              f"time ({lv_ms / busy_ms:.2%}) over {sum(e.count for e in levels)} chunks "
              f"(card: {card})", flush=True)
    for title, rows in (("kernels", kernels), ("operators", ops)):
        for e in sorted(rows, key=dev_ms, reverse=True)[:10]:
            print(f"[profile] {name} {title}: {dev_ms(e):8.3f} ms {dev_ms(e) / busy_ms:6.1%} "
                  f"{e.count:5d} calls  {e.key[:100]}", flush=True)
    return busy_ms


def card_vs_cpu(ckpt, torch):
    import numpy as np

    from semseg_tpu_torch.data import PyramidBuilder
    from semseg_tpu_torch.checkpoint import resolve_reference_checkpoint
    from semseg_tpu_torch.cli.eval import build_engines

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[f32] TF32 off for cuDNN convolutions and matmuls", flush=True)
    cfg = _cfg("DIR", ckpt, "DATASET.imgSizes", "(300, 375)")
    resolve_reference_checkpoint(cfg, cfg.TEST.checkpoint)
    h, w = 375, 500
    img = np.random.RandomState(2).randint(0, 256, (h, w, 3), np.uint8)
    pyramid = PyramidBuilder(cfg.DATASET).multi_scale_pyramid(img)

    cfg.TPU.compute_dtype = "float32"
    card = build_engines(cfg, 1, exact=True, device="cuda")[0].scores_for_pyramid(pyramid, (h, w))
    cpu = build_engines(cfg, 1, exact=True, device="cpu")[0].scores_for_pyramid(pyramid, (h, w))
    err = float(np.abs(card - cpu).max())
    agree = float((card.argmax(-1) == cpu.argmax(-1)).mean())
    print(f"[f32] card vs CPU: max |dp| {err:.3e}, argmax agreement {agree:.6f}", flush=True)
    if not (np.isfinite(card).all() and err <= 1e-3 and agree > 0.999):
        raise RuntimeError("float32 card output disagrees with the CPU")

    cfg.TPU.compute_dtype = "bfloat16"
    bf16 = build_engines(cfg, 1, exact=True, device="cuda")[0].scores_for_pyramid(pyramid, (h, w))
    print(f"[bf16] bf16 vs f32 on the card (no threshold): max |dp| "
          f"{float(np.abs(bf16 - card).max()):.3e}, argmax agreement "
          f"{float((bf16.argmax(-1) == card.argmax(-1)).mean()):.6f}", flush=True)


def batched_f32(ckpt, work, torch):
    """f32, TF32 off: device metrics equal host metrics of the batched maps
    as integers; packed and unpacked batched maps agree with the per-image
    engine."""
    import numpy as np

    from semseg_tpu_torch.utils import accuracy, intersectionAndUnion
    from semseg_tpu_torch.checkpoint import resolve_reference_checkpoint
    from semseg_tpu_torch.cli.eval import build_engines

    odgt = _write_val_set(os.path.join(work, "val_f32"), F32_IMAGES, seed=3)
    cfg = _cfg("DIR", ckpt, "DATASET.imgSizes", "(300, 375)", "TPU.compute_dtype", "float32")
    resolve_reference_checkpoint(cfg, cfg.VAL.checkpoint)
    pyrs, labels = _val_items(cfg, os.path.dirname(odgt), odgt)
    seg_sizes = [lab.shape for lab in labels]
    packed = build_engines(cfg, 1, batch=4, pack_buckets=True, device="cuda")[0]
    metrics = packed.batched_metrics(pyrs, labels)
    for (a_s, p_s, d_inter, d_union), pred, lab in zip(
            metrics, packed.batched_predict(pyrs, seg_sizes), labels):
        acc, pix = accuracy(pred, lab)
        inter, union = intersectionAndUnion(pred, lab, cfg.DATASET.num_class)
        if not (int(p_s) == int(pix) and int(a_s) == int(round(acc * int(pix)))
                and np.array_equal(d_inter.astype(np.int64), inter)
                and np.array_equal(d_union.astype(np.int64), union)):
            raise RuntimeError("batched_metrics disagrees with host metrics of its maps")
    print(f"[f32] batched_metrics == host accuracy/intersectionAndUnion over batched_predict "
          f"maps, as integers, on {len(pyrs)} images", flush=True)

    folded = {i for k, t in packed._group_by_bucket(pyrs).items()
              for i, _, h, w in t if packed._bucket_key(h, w) != k}
    if not folded:
        raise RuntimeError("packing folded no task of the f32 images")
    single = build_engines(cfg, 1, device="cuda")[0]
    singles = [single.predict(pyr, hw) for pyr, hw in zip(pyrs, seg_sizes)]
    plain = build_engines(cfg, 1, batch=4, pack_buckets=False, device="cuda")[0]
    failed = []
    for name, eng in (("packed", packed), ("unpacked", plain)):
        preds = eng.batched_predict(pyrs, seg_sizes)
        for i, (pred, ref, hw) in enumerate(zip(preds, singles, seg_sizes)):
            fold = eng is packed and i in folded
            limit = AGREE_FOLDED if fold else AGREE
            agree = float((pred == ref).mean())
            print(f"[f32] batched_predict ({name}{', levels folded' if fold else ''}) vs "
                  f"per-image bucketed engine {hw}: argmax agreement {agree:.6f} "
                  f"(limit > {limit})", flush=True)
            if agree <= limit:
                failed.append((name, hw, agree))
    if failed:
        raise RuntimeError(f"batched maps disagree with the per-image engine: {failed}")


def levels_vs_pil(work, torch):
    """f32, TF32 off: the device-pyramid engine's levels, derived on the
    card, against PIL's resize of the same originals to the same shapes."""
    import numpy as np
    from PIL import Image

    from semseg_tpu_torch.data.transforms import MEAN, STD
    from semseg_tpu_torch.engine import DevicePyramidEngine

    cfg = _cfg()
    eng = _plan_engine(DevicePyramidEngine, cfg, img_sizes=cfg.DATASET.imgSizes,
                       img_max_size=cfg.DATASET.imgMaxSize)
    rng = np.random.RandomState(6)
    worst = (0.0, 0.0)
    for h, w in F32_IMAGES:
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (h + w)], -1)
        ori = np.clip(base + rng.randint(-40, 41, (h, w, 3)), 0, 255).astype(np.uint8)
        canvas = torch.zeros((1, -(-h // 64) * 64, -(-w // 64) * 64, 3), dtype=torch.uint8)
        canvas[0, :h, :w] = torch.from_numpy(ori)
        canvas = canvas.cuda()
        ohw = torch.tensor([[h, w]], dtype=torch.int32, device="cuda")
        for th, tw in eng.level_plan(h, w):
            thw = torch.tensor([[th, tw]], dtype=torch.int32, device="cuda")
            x = eng._levels(canvas, ohw, thw, th, tw)[0].cpu().numpy()
            got = (x * STD + MEAN) * 255.0
            ref = np.asarray(Image.fromarray(ori).resize((tw, th), Image.BILINEAR), np.float32)
            err = np.abs(got - ref)
            worst = (max(worst[0], float(err.max())), max(worst[1], float(err.mean())))
            if err.max() > PIL_MAX or err.mean() > PIL_MEAN:
                raise RuntimeError(f"level {th}x{tw} of a {h}x{w} original differs from PIL: "
                                   f"max {err.max():.3f}, mean {err.mean():.3f}")
    print(f"[f32] device-derived levels vs PIL BILINEAR ({len(F32_IMAGES)} originals x "
          f"{len(cfg.DATASET.imgSizes)} levels): max |d| {worst[0]:.4f} (limit {PIL_MAX}), largest mean |d| {worst[1]:.4f} "
          f"(limit {PIL_MEAN}) grey levels", flush=True)


def dp_vs_host_f32(ckpt, val_dir, odgt, torch):
    """f32, TF32 off: device-pyramid metrics against the host-pyramid
    batched engine on the same images (only the resize backend differs)."""
    import numpy as np

    from semseg_tpu_torch.checkpoint import resolve_reference_checkpoint
    from semseg_tpu_torch.cli.eval import build_engines
    from semseg_tpu_torch.data import ValDataset

    cfg = _cfg("DIR", ckpt, "TPU.compute_dtype", "float32")
    resolve_reference_checkpoint(cfg, cfg.VAL.checkpoint)
    pyrs, labels = _val_items(cfg, val_dir, odgt)
    oris = [it["img_ori"] for it in (ValDataset(val_dir, odgt, cfg.DATASET, device_preprocess=True,
                                                device_pyramid_canvas=(1088, 1600))[i]
                                     for i in range(len(pyrs)))]
    host = build_engines(cfg, 1, batch=4, pack_buckets=True, device="cuda")[0]
    dev = build_engines(cfg, 1, batch=4, pack_buckets=True, device_pyramid=True,
                        device="cuda")[0]
    worst = np.zeros(3)
    for (ha, hp, hi, hu), (da, dp, di, du) in zip(
            host.batched_metrics(pyrs, labels), dev.batched_metrics_from_originals(oris, labels)):
        if hp != dp:
            raise RuntimeError(f"device-pyramid counted {dp} labelled pixels, host {hp}")
        d = np.array([abs(ha - da), np.abs(hi - di).sum(), np.abs(hu - du).sum()]) / hp
        worst = np.maximum(worst, d)
    print(f"[f32] device-pyramid vs host-pyramid batched metrics on {len(pyrs)} images, "
          f"{len(cfg.DATASET.imgSizes)} scales: equal pixel counts; largest |dacc|/pix {worst[0]:.5f} (< {DP_ACC}), "
          f"sum|dinter|/pix {worst[1]:.5f} (< {DP_INTER}), sum|dunion|/pix {worst[2]:.5f} "
          f"(< {DP_UNION})", flush=True)
    if not (worst[0] < DP_ACC and worst[1] < DP_INTER and worst[2] < DP_UNION):
        raise RuntimeError("device-pyramid metrics drift from the host-pyramid engine's")


def zoo_card_vs_cpu(ckpts, torch):
    """f32, TF32 off: each zoo config's exact engine on the card against
    the CPU, one small image, 2 scales."""
    import numpy as np

    from semseg_tpu_torch.checkpoint import resolve_reference_checkpoint
    from semseg_tpu_torch.cli.eval import build_engines
    from semseg_tpu_torch.data import PyramidBuilder

    h, w = 120, 160
    img = np.random.RandomState(7).randint(0, 256, (h, w, 3), np.uint8)
    for name, ckpt in ckpts.items():
        cfg = _cfg("DIR", ckpt, "DATASET.imgSizes", "(96, 128)", "TPU.compute_dtype", "float32",
                   path=os.path.join(HERE, "config", name))
        resolve_reference_checkpoint(cfg, cfg.VAL.checkpoint)
        pyramid = PyramidBuilder(cfg.DATASET).multi_scale_pyramid(img)
        engines = [build_engines(cfg, 1, exact=True, device=d)[0] for d in ("cuda", "cpu")]
        card, cpu = (e.scores_for_pyramid(pyramid, (h, w)) for e in engines)
        rel, scale = 0.0, 0.0
        with torch.inference_mode():
            for level in pyramid:
                a, b = (e.model(e._to_device(level)).cpu() for e in engines)
                scale = max(scale, b.abs().max().item())
                rel = max(rel, ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item())
        err = float(np.abs(card - cpu).max())
        agree = float((card.argmax(-1) == cpu.argmax(-1)).mean())
        print(f"[f32] zoo {cfg.MODEL.arch_encoder} + {cfg.MODEL.arch_decoder}: card vs CPU "
              f"logits max |d| / max |logit| {rel:.3e} (limit {ZOO_REL}; largest |logit| "
              f"{scale:.4g}), argmax agreement of the averaged scores {agree:.6f} (limit > "
              f"{ZOO_AGREE}), max |dp| {err:.3e}", flush=True)
        if not (np.isfinite(card).all() and rel <= ZOO_REL and agree > ZOO_AGREE):
            raise RuntimeError(f"{name}: float32 card output disagrees with the CPU")


def check_backward_kernel(ppm_pool, torch) -> float:
    """The backward kernel against its plain version (phase 8); two
    launches on the same gradients must agree bit for bit. Returns the
    largest absolute difference."""
    max_err = 0.0
    g = torch.Generator(device="cuda").manual_seed(8)
    lib = ppm_pool._lib()
    cases = [(shape, dt, False) for shape in BACKWARD_CHECKS for dt in ("float32", "bfloat16")]
    cases += [((2, 75, 100, 2048), dt, True) for dt in ("float32", "bfloat16")]
    for shape, dt, unaligned in cases:
        dtype = getattr(torch, dt)
        n, h, w, c = shape
        grads = []
        for s in ppm_pool.SCALES:
            flat = torch.randn(n * s * s * c + 1, generator=g, device="cuda").to(dtype)
            grads.append((flat[1:] if unaligned else flat[:-1]).view(n, s, s, c))
        out = ppm_pool.launch_backward(lib, grads, (h, w))
        again = ppm_pool.launch_backward(lib, grads, (h, w))
        ref = ppm_pool.pyramid_pool_backward_plain(grads, (h, w))
        if not torch.equal(out, again):
            raise RuntimeError(f"pyramid_pool backward {shape} {dt}: two launches differ")
        # f32: the same terms in the same order, times the area's reciprocal
        # in the kernel and divided by the area in the plain version, one
        # rounding apart per term; bf16: one bf16 ulp.
        tol = dict(atol=1e-6, rtol=1e-6) if dtype == torch.float32 else dict(atol=1e-6, rtol=8e-3)
        torch.testing.assert_close(out.float(), ref.float(), **tol)
        err = (out.float() - ref.float()).abs().max().item()
        max_err = max(max_err, err)
        where = ", unaligned gradients" if unaligned else ""
        print(f"[check] pyramid_pool backward {shape} {dt}{where}: ok, max |d| {err:.3e}, "
              "two launches bit-equal", flush=True)
    torch.cuda.synchronize()
    return max_err


def backward_bound_ms(shape, element_size):
    """Least time for one backward call on an H100 SXM: grad_x written once
    and the 50 bin gradients per channel read once over 3.35 TB/s, against
    its adds (50 terms per cell and channel, at most 121 cells) at 67
    TFLOP/s."""
    n, h, w, c = shape
    moved = (n * h * w + 50 * n) * c * element_size
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = 2 * 50 * 121 * n * c / 67e12 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_backward_against(ppm_pool, torch, other) -> None:
    """``--compare``: the backward of this build equals the other build's
    bit for bit at every BACKWARD_CHECKS shape and dtype (same terms, same
    order, one rounding)."""
    g = torch.Generator(device="cuda").manual_seed(9)
    this = ppm_pool._lib()
    for shape in BACKWARD_CHECKS:
        n, h, w, c = shape
        for dt in ("float32", "bfloat16"):
            grads = [torch.randn(n, s, s, c, generator=g, device="cuda").to(getattr(torch, dt))
                     for s in ppm_pool.SCALES]
            mine = ppm_pool.launch_backward(this, grads, (h, w))
            theirs = ppm_pool.launch_backward(other, grads, (h, w))
            if not torch.equal(mine, theirs):
                raise RuntimeError(f"pyramid_pool backward {shape} {dt}: this build differs from "
                                   f"the other by {(mine.float() - theirs.float()).abs().max():.3e}")
            print(f"[compare] pyramid_pool backward {shape} {dt}: bit-equal to the other build",
                  flush=True)


def _device_us(fn, torch, flush, names, what):
    """Device time (us) of one call of ``fn`` under torch.profiler, over 10
    cold calls that must launch one kernel of ``names`` each; None where the
    profiler recorded no device activity."""
    dev = _matching(_profiled(fn, torch, flush, names=names), names, what)
    if not dev:
        return None
    if sum(e.count for e in dev) != 10:
        raise RuntimeError(f"{what}: {[e.count for e in dev]} kernels for 10 calls")
    return sum(e.self_device_time_total for e in dev) / 10


def _us(us):
    return "not measured (no device activity recorded)" if us is None else f"{us:.2f} us"


def _turns(fn_of, libs, torch, flush, card, what, names=()):
    """``--compare``: ``fn_of(lib)`` timed cold and warm in turns, other,
    this, this, other, on one card; with ``names``, also the device time of
    its kernel (one of ``names``) under the profiler."""
    runs = []
    for who in ("other", "this", "this", "other"):
        fn = fn_of(libs[who])
        run = f"{who} {_median_ms(fn, torch, flush):.4f} cold / {_median_ms(fn, torch):.4f} warm"
        if names:
            run += f" / {_us(_device_us(fn, torch, flush, names, f'{what} ({who})'))} device"
        runs.append(run)
    print(f"[compare] {what} (ms): " + "; ".join(runs) + f" (card: {card})", flush=True)


def time_backward(ppm_pool, torch, card, compare=None) -> dict:
    """Phase 8: (warm ms, cold ms, plain ms, bound ms, bound_by, device ms)
    of the backward kernel per timed shape and dtype, the last from the
    profiler (one kernel per call; None where it recorded no device
    activity). With ``compare``, the other build in turns."""
    flush = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    lib = ppm_pool._lib()
    out = {}
    for shape in BACKWARD_TIMED:
        n, h, w, c = shape
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            grads = [torch.randn(n, s, s, c, device="cuda").to(dtype) for s in ppm_pool.SCALES]
            run = lambda: ppm_pool.launch_backward(lib, grads, (h, w))  # noqa: E731
            warm = _median_ms(run, torch)
            cold = _median_ms(run, torch, flush)
            plain = _median_ms(lambda: ppm_pool.pyramid_pool_backward_plain(grads, (h, w)), torch)
            bound, bound_by = backward_bound_ms(shape, grads[0].element_size())
            us = _device_us(run, torch, flush, (BACKWARD_KERNEL,),
                            f"pyramid_pool backward {shape}")
            out[(shape, dt)] = (warm, cold, plain, bound, bound_by, None if us is None else us / 1e3)
            print(f"[time] pyramid_pool backward {shape} {dt}: kernel {warm:.4f} ms warm, "
                  f"{cold:.4f} ms cold; bound {bound:.4f} ms ({bound_by}), share of bound "
                  f"{bound / cold:.3f} cold, {bound / warm:.3f} warm; kernel under the profiler "
                  f"(cold) {_us(us)}; plain {plain:.4f} ms (median of 50; card: {card})",
                  flush=True)
            if compare is not None:
                _turns(lambda lb: lambda: ppm_pool.launch_backward(lb, grads, (h, w)),
                       {"this": lib, "other": compare}, torch, flush, card,
                       f"pyramid_pool backward {shape} {dt}",
                       (BACKWARD_KERNEL,))
    return out


def _train_cfg_opts(root, odgt):
    return ["DATASET.root_dataset", root, "DATASET.list_train", odgt, "DATASET.list_val", odgt,
            "TRAIN.epoch_iters", str(TRAIN_ITERS), "TRAIN.disp_iter", "2", "TRAIN.workers", "2"]


def train_phase(work, torch, ppm_pool, card):
    """The flagship at full width, bf16, batch 2 (the config's) through
    ``cli.train``: epoch 1, a resume into epoch 2, then ``cli.eval`` of the
    ``epoch_2.pth`` pair. Returns the launches of the training runs and of
    the eval."""
    import numpy as np

    from semseg_tpu_torch.cli import eval as eval_cli, train as train_cli

    root = os.path.join(work, "train_set")
    odgt = _write_val_set(root, TRAIN_IMAGES, seed=9)
    out = os.path.join(work, "train_run")
    opts = ["DIR", out, *_train_cfg_opts(root, odgt)]
    launches = {"dense": 0, "valid": 0, "backward": 0}
    # Epoch 1 as a run of one epoch, then a resume of it into a run of two
    # (the poly schedule's horizon grows from 4 to 8 steps at the resume).
    for name, extra, want_history in (
            ("cli.train epoch 1", ["TRAIN.num_epoch", "1"], 2),
            ("cli.train resumed into epoch 2", ["TRAIN.num_epoch", "2", "TRAIN.start_epoch", "1"],
             2)):
        (state, history), seconds, dense, valid = _run_path(
            name, lambda: train_cli.main(["--cfg", CFG, "--devices", "1", *opts, *extra]),
            ppm_pool, torch,
            backward=TRAIN_ITERS)
        losses = history["train"]["loss"]
        if (dense, valid) != (TRAIN_ITERS, 0) or len(losses) != want_history:
            raise RuntimeError(f"{name}: pool launches dense {dense} / valid {valid} "
                               f"(expected {TRAIN_ITERS} / 0), history {history}")
        if not all(np.isfinite(losses)):
            raise RuntimeError(f"{name}: non-finite loss in {losses}")
        launches["dense"] += dense
        launches["backward"] += ppm_pool.BACKWARD_LAUNCHES
        print(f"[train] {name}: {TRAIN_ITERS} steps at batch 2, bf16, full width, now at step "
              f"{state.step}; losses at the display steps {[round(x, 4) for x in losses]}; "
              f"{seconds:.1f} s wall (model build, loader start and cuDNN set-up for each new "
              f"canvas included; card: {card})", flush=True)
    pair = [os.path.join(out, f"{p}_epoch_2.pth") for p in ("encoder", "decoder")]
    if not all(os.path.exists(p) for p in pair):
        raise RuntimeError(f"cli.train wrote no epoch_2 pair in {os.listdir(out)}")
    chunks = expected_chunks(_cfg(*_train_cfg_opts(root, odgt)), root, odgt, flagship=False)
    (miou, acc, _, raw), _, dense, valid = _run_path(
        "cli.eval of the trained epoch_2.pth pair", lambda: eval_cli.main(
            ["--cfg", CFG, "DIR", out, "VAL.checkpoint", "epoch_2.pth",
             *_train_cfg_opts(root, odgt)]), ppm_pool, torch)
    if (dense, valid) != (0, chunks) or not (np.isfinite(miou) and raw["pix_count"] > 0):
        raise RuntimeError(f"cli.eval of the trained pair: launches {dense}/{valid} (expected "
                           f"0/{chunks}), mIoU {miou}")
    launches["valid"] += valid
    print(f"[train] cli.eval VAL.checkpoint epoch_2.pth: mIoU {miou:.4f}, accuracy "
          f"{acc * 100:.2f}% over {raw['pix_count']:.0f} labelled pixels", flush=True)
    return launches, root, odgt


def _train_model(torch, cfg, device, seed=0, group=None, spatial=None):
    from semseg_tpu_torch.models import ModelBuilder
    from semseg_tpu_torch.parallel import create_train_state

    model = ModelBuilder.build_model(cfg, device=device, seed=seed)
    return create_train_state(cfg, model.train(), group, spatial_devices=spatial)


@contextlib.contextmanager
def _deterministic(torch):
    """cuDNN's deterministic algorithms (no autotuning) and PyTorch's
    deterministic kernels while entered (the bilinear resize's backward goes
    through ``index_put`` instead of atomic adds): repeated training steps
    on the card are then bit-equal. Outside, cuDNN's weight gradients and
    the resize's backward add in a varying order from run to run."""
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


def loss_falls(torch, root, odgt, card):
    """Five steps on one repeated batch of the written set: the loss falls.
    Under deterministic algorithms, so that the check reads the same five
    losses on every run instead of one draw from the card's rounding."""
    from semseg_tpu_torch.data import TrainDataset
    from semseg_tpu_torch.parallel import dropout_generator, train_step

    cfg = _cfg(*_train_cfg_opts(root, odgt))
    state = _train_model(torch, cfg, CARD)
    host = TrainDataset(root, odgt, cfg.DATASET, batch_per_gpu=2, seed=1,
                        bucket_step=cfg.TPU.bucket_step, raw_transport=True).next_batch()
    batch = {k: torch.from_numpy(v).to(CARD) for k, v in host.items()}
    with _deterministic(torch):
        losses = [float(train_step(state, batch, dropout_generator(0, i))["loss"])
                  for i in range(5)]
    print(f"[train] one repeated batch {tuple(host['img_data'].shape)}, 5 steps under "
          f"deterministic algorithms: losses "
          f"{[round(x, 4) for x in losses]} (card: {card})", flush=True)
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall on a repeated batch: {losses}")


def train_card_vs_cpu(torch, ppm_pool):
    """One float32 step, TF32 off, on the card and on the CPU from the same
    weights and batch, dropout at 0."""
    import numpy as np

    from semseg_tpu_torch.models.layers import Dropout2d
    from semseg_tpu_torch.parallel import train_step

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _cfg("TPU.compute_dtype", "float32")
    rng = np.random.RandomState(10)
    n, h, w = 2, 256, 320
    host = {"img_data": rng.randn(n, h, w, 3).astype(np.float32),
            "seg_label": rng.randint(-1, 150, (n, h // 8, w // 8)).astype(np.int32)}
    states = {}
    for device in (CARD, "cpu"):
        state = _train_model(torch, cfg, device)
        for m in state.model.modules():
            if isinstance(m, Dropout2d):
                m.p = 0.0
        batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        before = ppm_pool.BACKWARD_LAUNCHES
        loss = float(train_step(state, batch)["loss"])
        if device == CARD and ppm_pool.BACKWARD_LAUNCHES != before + 1:
            raise RuntimeError("the card's training step did not launch the backward kernel")
        states[device] = (state, loss)
    (card, card_loss), (cpu, cpu_loss) = states[CARD], states["cpu"]
    params = dict(cpu.model.named_parameters())
    report, failed = [], []
    for name in ("encoder.layer4.2.conv3.weight", "decoder.ppm.0.1.weight",
                 "decoder.ppm.3.1.weight", "decoder.conv_last.4.weight"):
        a = dict(card.model.named_parameters())[name].grad.cpu()
        b = params[name].grad
        rel = float((a - b).norm() / b.norm())
        report.append(f"{name} {rel:.3e}")
        if not rel < GRAD_REL:
            failed.append(name)
    stat_rel, stat_key = 0.0, ""
    for (k, a), b in zip(card.model.state_dict().items(), cpu.model.state_dict().values()):
        if "running" in k:
            rel = float((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1e-30))
            stat_rel, stat_key = max((stat_rel, stat_key), (rel, k))
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    print(f"[f32] one training step, card vs CPU (TF32 off, {n}x{h}x{w}, dropout 0): loss "
          f"{card_loss:.6f} vs {cpu_loss:.6f}, relative {loss_rel:.2e} (limit {LOSS_REL}); "
          f"gradients, relative norm error (limit {GRAD_REL}): " + ", ".join(report) +
          f"; BN statistics max |d| / max {stat_rel:.2e} ({stat_key}; limit {STAT_REL})",
          flush=True)
    if failed or not (loss_rel < LOSS_REL and stat_rel < STAT_REL):
        raise RuntimeError(f"float32 training step: card disagrees with the CPU ({failed})")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def fix_bn_step(torch, card):
    """``TRAIN.fix_bn``: one bf16 training step of the flagship at batch 2
    with every BN in eval mode under a gradient. Each BN call is one kernel
    launch (its forward; the backward is the operator's plain ops), and
    under deterministic algorithms the step is bit-equal (loss, every
    gradient, the updated weights, the running statistics) to the same step
    with the plain chain under the BNs. Returns the kernel launches."""
    import numpy as np

    from semseg_tpu_torch.models import layers
    from semseg_tpu_torch.models.layers import BatchNorm2d
    from semseg_tpu_torch.ops.kernels import bn_act
    from semseg_tpu_torch.parallel import train_step

    cfg = _cfg("TRAIN.fix_bn", "True")
    rng = np.random.RandomState(13)
    n, h, w = 2, 320, 448
    host = {"img_data": rng.randn(n, h, w, 3).astype(np.float32),
            "seg_label": rng.randint(-1, 150, (n, h // 8, w // 8)).astype(np.int32)}
    runs = {}
    for name in ("kernel", "plain"):
        state = _train_model(torch, cfg, CARD)
        calls = [0]
        hooks = [m.register_forward_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
                 for m in state.model.modules() if isinstance(m, BatchNorm2d)]
        if not hooks or any(m.training for m in state.model.modules()
                            if isinstance(m, BatchNorm2d)):
            raise RuntimeError("TRAIN.fix_bn: the model's BNs are not all in eval mode")
        batch = {k: torch.from_numpy(v).to(CARD) for k, v in host.items()}
        before = bn_act.LAUNCHES
        saved = layers.bn_act
        if name == "plain":
            layers.bn_act = bn_act.bn_act_plain
        try:
            with _deterministic(torch):
                loss = float(train_step(state, batch)["loss"])
        finally:
            layers.bn_act = saved
        for hook in hooks:
            hook.remove()
        runs[name] = (state, loss, calls[0], bn_act.LAUNCHES - before)
    (kernel, loss, calls, launched), (plain, plain_loss, plain_calls, plain_launched) = \
        runs["kernel"], runs["plain"]
    if launched != calls or plain_launched or calls != plain_calls:
        raise RuntimeError(f"TRAIN.fix_bn step: {calls} BN calls, {launched} kernel launches "
                           f"(the plain step: {plain_calls} calls, {plain_launched} launches)")
    differ = [k for (k, a), b in zip(kernel.model.named_parameters(),
                                     plain.model.parameters())
              if not (torch.equal(a.grad, b.grad) and torch.equal(a, b))]
    differ += [k for (k, a), b in zip(kernel.model.named_buffers(), plain.model.buffers())
               if not torch.equal(a, b)]
    print(f"[train] TRAIN.fix_bn, one bf16 step {n}x{h}x{w} under deterministic algorithms: "
          f"{calls} BN calls, each one kernel launch; loss {loss:.6f} against the plain chain's "
          f"{plain_loss:.6f}; {len(differ)} parameters, gradients or buffers differ "
          f"(card: {card})", flush=True)
    if differ or loss != plain_loss:
        raise RuntimeError(f"TRAIN.fix_bn step: the kernel's differs from the plain chain's in "
                           f"{differ[:5]} (loss {loss} against {plain_loss})")
    return launched


def train_steady_state(torch, card):
    """bench.py's train step on the card: random f32 images and labels
    already on the device, the flagship in bf16; s/step over 3 x 10 steps
    after one warm-up step, peak memory, and a profile of one step."""
    import numpy as np

    from semseg_tpu_torch.parallel import dropout_generator, train_step

    cfg = _cfg()
    out = {}
    for batch_size in (2, BENCH_TRAIN[0]):
        _, h, w = BENCH_TRAIN
        rng = np.random.RandomState(0)
        batch = {"img_data": torch.from_numpy(
                     rng.randn(batch_size, h, w, 3).astype(np.float32)).to(CARD),
                 "seg_label": torch.from_numpy(
                     rng.randint(-1, 150, (batch_size, h // 8, w // 8)).astype(np.int32)).to(CARD)}
        state = _train_model(torch, cfg, CARD)
        step = lambda: train_step(state, batch, dropout_generator(0, state.step))  # noqa: E731
        float(step()["loss"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(3):
            tic = time.perf_counter()
            for _ in range(10):
                m = step()
            loss = float(m["loss"])
            runs.append((time.perf_counter() - tic) / 10)
        if not np.isfinite(loss):
            raise RuntimeError(f"steady state: non-finite loss {loss}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        best, med = min(runs), sorted(runs)[1]
        out[batch_size] = (best, med, peak)
        print(f"[steady] train step, flagship bf16, batch {batch_size}, {h}x{w} (bench.py's "
              f"shape): {best:.4f} s/step best, {med:.4f} median of 3 x 10 steps = "
              f"{batch_size / best:.1f} img/s best, {batch_size / med:.1f} median; peak device "
              f"memory {peak:.2f} GiB (card: {card})", flush=True)
        if batch_size == BENCH_TRAIN[0]:
            profile_train_step(step, torch, card, med)
        del state, batch
        torch.cuda.empty_cache()
    return out


TRAIN_KERNEL_GROUPS = (
    ("pool forward", FORWARD_KERNELS),
    ("pool backward", (BACKWARD_KERNEL,)),
    ("convolutions (cuDNN)", ("conv", "xmma", "gemm", "cudnn", "implicit", "wgrad", "dgrad",
                              "cutlass", "sm90_", "sm80_", "nchwToNhwc", "nhwcToNchw")),
    ("casts and copies", ("copy",)),
    ("reductions (BN statistics, loss sums)", ("reduce_kernel",)),
    ("optimizer (foreach SGD)", ("multi_tensor_apply",)),
    ("other elementwise (BN affine and its backward, ReLU, adds, loss)", ("elementwise",)),
)


def profile_train_step(step, torch, card, wall_s):
    """One profiled train step: device time by the train step's ranges
    (forward, backward, optimizer) and by kernel group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_profile_train.txt"), "w") as f:
        f.write(f"card: {card}\n")
        f.write(events.table(sort_by="self_device_time_total", row_limit=80,
                             max_name_column_width=120))
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        print("[profile] train step: the profiler recorded no device time; not measured",
              flush=True)
        return
    for group, keys in TRAIN_KERNEL_GROUPS[:2]:  # the pool's, one forward and one backward
        _matching(kernels, keys, f"the train step's {group}")
    groups = {name: 0.0 for name, _ in TRAIN_KERNEL_GROUPS}
    groups["other"] = 0.0
    for e in kernels:
        name = next((g for g, keys in TRAIN_KERNEL_GROUPS if any(k in e.key for k in keys)),
                    "other")
        groups[name] += e.self_device_time_total / 1e3
    # Autograd launches the backward's kernels from its own thread, outside
    # the semseg::backward range: the backward is what the forward and
    # optimizer ranges leave.
    ranges = {e.key: e.device_time_total / 1e3 for e in events
              if e.key in ("semseg::forward", "semseg::optimizer")
              and e.device_type == DeviceType.CPU}
    fwd, opt = ranges.get("semseg::forward", 0.0), ranges.get("semseg::optimizer", 0.0)
    print(f"[profile] train step (batch {BENCH_TRAIN[0]}): device kernel time {busy:.1f} ms "
          f"against {wall_s * 1e3:.1f} ms of wall per step without the profiler, so device idle "
          f"share about {max(0.0, 1 - busy / (wall_s * 1e3)):.3f}; forward {fwd:.1f} ms, "
          f"backward {busy - fwd - opt:.1f} ms, optimizer {opt:.1f} ms (card: {card})",
          flush=True)
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile] train step kernels, {name}: {ms:8.3f} ms {ms / busy:6.1%}", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[profile] train step top kernels: {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:5d} calls  {e.key[:100]}", flush=True)


def _post_all(url, bodies, concurrency):
    """POST every body to ``url`` from ``concurrency`` client threads.
    Returns (wall seconds, [(status, client seconds, payload)] in order)."""
    import urllib.error
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    def post(body):
        tic = time.perf_counter()
        req = urllib.request.Request(url, data=body, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                status, payload = resp.status, resp.read()
        except urllib.error.HTTPError as e:
            status, payload = e.code, e.read()
        return status, time.perf_counter() - tic, payload

    tic = time.perf_counter()
    with ThreadPoolExecutor(max_workers=concurrency) as pool:
        results = list(pool.map(post, bodies))
    return time.perf_counter() - tic, results


def _pct(values, q):
    """The server's percentile rule (``MicroBatcher.stats``)."""
    values = sorted(values)
    return values[min(int(len(values) * q), len(values) - 1)]


class _SlotRecord:
    """The bundle's label map of each request predicted alone at every slot
    of its program's batch (zero images in the other slots, as
    ``Predictor.predict_batch`` pads a chunk), and a record of the slots
    that served traffic put each request in. cuDNN's bf16 dilated
    convolution (``encoder.layer4.0.conv2``) rounds the last sample of a
    full batch unlike the others (slots 0-2 bit-equal on an H100), and a
    request served at slot 3 came out at 0.998993 of its slot-0 map: a
    served map is held against its request predicted at its own slot. A
    map that took in another slot's request, or lost its own, still
    fails."""

    def __init__(self, pred, decoded):
        import numpy as np
        from PIL import Image

        keys = [pred._pick(*d.shape[:2]) for d in decoded]
        self.at = [[pred.predict_batch([np.zeros_like(d)] * slot + [d])[slot]
                    for d in decoded] for slot in range(max(k[0] for k in keys))]
        # Each request's program input: predict_batch's resize to its bucket.
        self.inputs = [np.asarray(Image.fromarray(d).resize((bw, bh), Image.BILINEAR),
                                  np.uint8) for d, (_, bh, bw) in zip(decoded, keys)]
        self.calls = []
        for key, program in list(pred.programs.items()):
            pred.programs[key] = self._recorded(program)

    def _recorded(self, program):
        def call(params, img_u8):
            self.calls.append(img_u8)  # a fresh tensor per call, never written
            return program(params, img_u8)
        return call

    def spread(self):
        """The least agreement of a request's map at any slot with its map at
        slot 0."""
        return min(float((m == m0).mean()) for row in self.at[1:]
                   for m, m0 in zip(row, self.at[0]))

    def served(self):
        """Per request, the slots that the calls since the last ``served``
        put it in."""
        import numpy as np

        slots = [set() for _ in self.inputs]
        for batch in self.calls:
            for j, x in enumerate(batch.cpu().numpy()):
                for i, want in enumerate(self.inputs):
                    if want.shape == x.shape and np.array_equal(want, x):
                        slots[i].add(j)
        self.calls.clear()
        return slots


def _serve_traffic(name, server, bodies, lone, agree, card, record=None,
                   concurrency=SERVE_CONCURRENCY):
    """Request rounds at each concurrency against a bound server, after a
    warm round; every round sends each of ``bodies`` twice. ``lone`` holds
    the backend's own label map of each decoded body, predicted alone.
    Every answer must be 200. At one client each request is alone in its
    batch, so its label map must equal its reference. With more clients
    each map must agree with its own reference within ``agree`` (None: more
    than with the reference of any other request of its shape; the live
    engine's packing may fold a level into a larger bucket with co-batched
    requests, whose extra zero pad the convolutions carry in). With
    ``record`` (a ``_SlotRecord``) a map's references are its request's
    maps predicted alone at the slots the round served it in. Returns the
    batches the backends ran, and with several backends each one's."""
    import io
    import urllib.request

    import numpy as np

    def agreement(m, refs):
        return max([float((m == r).mean()) for r in refs if m is not None
                    and r.shape == m.shape], default=0.0)

    url = f"http://127.0.0.1:{server.server_address[1]}"
    server.serve_background()
    with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
        health = json.load(resp)
    print(f"[serve] {name}: /healthz {health}", flush=True)
    if health["status"] != "ok":
        raise RuntimeError(f"{name}: /healthz {health}")
    sent = bodies * 2
    _post_all(url + "/segment?format=npy", sent, max(concurrency))
    batches, per_backend = 0, None
    for conc in concurrency:
        server.batcher.reset_stats()
        if record is not None:
            record.served()
        wall, results = _post_all(url + "/segment?format=npy", sent, conc)
        with urllib.request.urlopen(url + "/stats", timeout=60) as resp:
            stats = json.load(resp)
        bad = [st for st, _, _ in results if st != 200]
        lats = [t * 1e3 for _, t, _ in results]
        maps = [np.load(io.BytesIO(p)) if st == 200 else None for st, _, p in results]
        slots = None if record is None else record.served()
        refs = ([[m] for m in lone] if slots is None else
                [[record.at[j][i] for j in sorted(js)] for i, js in enumerate(slots)])
        own = [k % len(bodies) for k in range(len(sent))]
        shares = [agreement(m, refs[i]) for m, i in zip(maps, own)]
        alone = [agreement(m, [lone[i]]) for m, i in zip(maps, own)]
        others = [max([agreement(m, [r]) for j, r in enumerate(lone) if j != i], default=0.0)
                  for m, i in zip(maps, own)]
        at_slot = "" if slots is None else (
            f", at the slots its request was served in {min(shares):.6f} (requests per slot "
            f"{[sum(j in js for js in slots) for j in range(len(record.at))]})")
        if "backend_batches" in stats:
            per_backend = [a + b for a, b in zip(per_backend or [0] * len(
                stats["backend_batches"]), stats["backend_batches"])]
        print(f"[serve] {name}, {conc} client(s), {len(sent)} requests: "
              f"{len(sent) / wall:.2f} req/s, mean_batch_fill {stats['mean_batch_fill']:.2f} "
              f"({stats['batches']} batches"
              f"{', per backend ' + str(stats.get('backend_batches')) if per_backend else ''})"
              f", /stats latency p50 {stats['latency_ms_p50']:.1f} / "
              f"p95 {stats['latency_ms_p95']:.1f} ms, client p50 {_pct(lats, 0.5):.1f} / p95 "
              f"{_pct(lats, 0.95):.1f} / max {max(lats):.1f} ms, non-200 {len(bad)}; each map "
              f"against its request predicted alone: agreement min {min(alone):.6f}{at_slot} "
              f"(closest other request max {max(others):.6f}); card: {card}", flush=True)
        if bad or stats["errors"] or stats["requests"] != len(sent):
            raise RuntimeError(f"{name}, {conc} clients: statuses {bad}, stats {stats}")
        if min(shares) < (1.0 if conc == 1 else agree or 0.0) \
                or (agree is None and any(a <= b for a, b in zip(shares, others))):
            raise RuntimeError(f"{name}, {conc} clients: a label map departs from the "
                               f"backend's own: agreement {shares}, with the closest other "
                               f"request's {others}")
        batches += stats["batches"]
    return batches, per_backend


def _serve_requests():
    """Phase 9's JPEG request bodies, of shapes sampled from the val
    manifest, and their PIL decodes."""
    import io

    import numpy as np
    from PIL import Image

    from semseg_tpu_torch.data.dataset import sample_odgt_shapes

    shapes = sample_odgt_shapes(os.path.join(HERE, "data", "validation.odgt"), SERVE_REQUESTS,
                                seed=0)
    rng = np.random.RandomState(12)
    bodies, decoded = [], []
    for h, w in shapes:
        # Gradients in a random channel order and direction plus noise:
        # JPEG-friendly, and no two requests of one shape alike.
        yy, xx = np.mgrid[0:h, 0:w]
        if rng.rand() < 0.5:
            yy, xx = yy[::-1], xx[:, ::-1]
        base = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (h + w)], -1)
        img = base[..., rng.permutation(3)] + rng.randint(-60, 61, 3)
        img = np.clip(img + rng.randint(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=90)
        bodies.append(buf.getvalue())
        decoded.append(np.asarray(Image.open(io.BytesIO(bodies[-1])).convert("RGB")))
    print(f"[serve] {len(bodies)} JPEG requests, shapes sampled from data/validation.odgt "
          f"(seed 0): {shapes}; sent twice per round", flush=True)
    return bodies, decoded


def serving_phase(work, ckpt, torch, ppm_pool, card):
    """Phase 9: ``tools.export_serving`` exports the flagship's bundle
    (bf16, two buckets, batch 4) on the card; each program against the
    eager forward, one dense launch per program call; an f32 bundle on the
    card against the same one on the CPU; then ``cli.serve`` over the
    bundle and over the live engine (5 scales, batch 8, packed) on
    127.0.0.1, JPEG requests of val-manifest shapes from 1-16 clients;
    then admission control (``--max-queue 2``, 16 concurrent requests).
    Returns the launches of the served traffic."""
    import collections

    import numpy as np

    from semseg_tpu_torch.checkpoint import resolve_reference_checkpoint
    from semseg_tpu_torch.cli import serve as serve_cli
    from semseg_tpu_torch.models import ModelBuilder
    from semseg_tpu_torch.ops.kernels import bn_act
    from semseg_tpu_torch.ops.preproc import normalize_255
    from semseg_tpu_torch.ops.resize import resize_bilinear
    from semseg_tpu_torch.serving import Predictor
    from semseg_tpu_torch.tools import export_serving

    start = time.perf_counter()
    bundle = os.path.join(work, "bundle")
    tic = time.perf_counter()
    manifest = export_serving.main(["--cfg", CFG, "--out", bundle, "--shapes", SERVE_SHAPES,
                                    "--batch", str(SERVE_BATCH), "DIR", ckpt])
    export_s = time.perf_counter() - tic
    params = os.path.getsize(os.path.join(bundle, "params.pt"))
    sizes = {p["file"]: os.path.getsize(os.path.join(bundle, p["file"]))
             for p in manifest["programs"]}
    print(f"[serve] export of {len(sizes)} programs on the card: {export_s:.1f} s; "
          + ", ".join(f"{f} {n / 1e6:.3f} MB ({n / params:.2%} of params.pt)"
                      for f, n in sizes.items()) + f"; params.pt {params / 1e6:.1f} MB",
          flush=True)
    if manifest["device"] != "cuda" or max(sizes.values()) > PROGRAM_SHARE * params:
        raise RuntimeError(f"bundle: device {manifest['device']}, program files {sizes} "
                           f"against params.pt {params} bytes")

    server, (pred,) = serve_cli.build_server(
        ["--bundle", bundle, "--host", "127.0.0.1", "--port", "0", "--quiet",
         "--max-batch", str(SERVE_BATCH)])
    cfg = _cfg("DIR", ckpt)
    resolve_reference_checkpoint(cfg, cfg.TEST.checkpoint)
    model = ModelBuilder.build_model(cfg, device="cuda")
    rng = np.random.RandomState(11)
    for b, h, w in sorted(pred.programs):
        imgs = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for _ in range(b)]
        ppm_pool.LAUNCHES = 0
        bn_start = bn_act.LAUNCHES
        got = pred.predict_batch(imgs)
        torch.cuda.synchronize()
        if ppm_pool.LAUNCHES != 1:
            raise RuntimeError(f"program {b}x{h}x{w}: {ppm_pool.LAUNCHES} dense launches")
        bn_program = bn_act.LAUNCHES - bn_start
        with torch.no_grad():
            x = normalize_255(torch.from_numpy(np.stack(imgs)).to("cuda", torch.float32))
            logits = model(x.permute(0, 3, 1, 2))
            want = resize_bilinear(logits.to(torch.float32), (h, w)).argmax(dim=1).cpu().numpy()
        bn_eager = bn_act.LAUNCHES - bn_start - bn_program
        if bn_program == 0 or bn_program != bn_eager:
            raise RuntimeError(f"program {b}x{h}x{w}: {bn_program} BN kernel launches, the eager "
                               f"forward {bn_eager}")
        shares = [float((g == wm).mean()) for g, wm in zip(got, want)]
        print(f"[serve] program {b}x{h}x{w} against the eager forward (bf16): argmax "
              f"agreement {min(shares):.6f} (limit {AGREE}), 1 dense launch and {bn_program} "
              "BN kernel launches per call (the eager forward's)", flush=True)
        if min(shares) < AGREE:
            raise RuntimeError(f"program {b}x{h}x{w} disagrees with the eager forward: {shares}")
    del model
    mixed = [np.zeros((448, 608, 3), np.uint8)] * 5 + [np.zeros((608, 448, 3), np.uint8)] * 2
    ppm_pool.LAUNCHES = 0
    pred.predict_batch(mixed)
    if ppm_pool.LAUNCHES != 3:  # 5 landscape images in 2 calls, 2 portrait ones in 1
        raise RuntimeError(f"7 mixed images: {ppm_pool.LAUNCHES} dense launches, expected 3")
    serving_f32(work, ckpt, torch, Predictor, export_serving)

    bodies, decoded = _serve_requests()
    launches = {"dense": 0, "valid": 0}
    bn_start = bn_act.LAUNCHES

    lone = [pred.predict(d) for d in decoded]
    record = _SlotRecord(pred, decoded)
    print(f"[serve] each request predicted alone at each slot of its batch of "
          f"{len(record.at)}: least agreement with its slot-0 map {record.spread():.6f}",
          flush=True)
    (batches, _), _, dense, valid = _run_path("cli.serve --bundle traffic", lambda: _serve_traffic(
        "bundle", server, bodies, lone, AGREE, card, record), ppm_pool, torch)
    server.close()
    if not (batches <= dense <= 2 * batches and valid == 0):
        raise RuntimeError(f"bundle traffic: {batches} batches, launches dense {dense} / "
                           f"valid {valid}")
    launches["dense"] += dense

    server, (live,) = serve_cli.build_server(
        ["--cfg", CFG, "--host", "127.0.0.1", "--port", "0", "--quiet", "--max-batch", "8",
         "DIR", ckpt])
    lone = [live.predict_batch([d])[0] for d in decoded]
    _, _, dense, valid = _run_path("cli.serve --cfg (live) traffic", lambda: _serve_traffic(
        "live 5 scales", server, bodies, lone, None, card), ppm_pool, torch)
    server.close()
    if dense or not valid:
        raise RuntimeError(f"live traffic: launches dense {dense} / valid {valid}")
    launches["valid"] += valid

    server, _ = serve_cli.build_server(
        ["--cfg", CFG, "--host", "127.0.0.1", "--port", "0", "--quiet", "--no-warmup",
         "--max-queue", "2", "DIR", ckpt])
    server.serve_background()
    try:
        (_, results), _, dense, valid = _run_path("cli.serve --max-queue 2 overload", lambda: (
            _post_all(f"http://127.0.0.1:{server.server_address[1]}/segment", bodies, 16)),
            ppm_pool, torch)
    finally:
        server.close()
    codes = collections.Counter(st for st, _, _ in results)
    print(f"[serve] --max-queue 2, 16 concurrent requests: statuses {dict(codes)}", flush=True)
    if not codes[503] or set(codes) - {200, 503}:
        raise RuntimeError(f"overload: statuses {dict(codes)}; expected 503s and no 500")
    launches["valid"] += valid
    # The served traffic's BN launches (the three servers; the live ones
    # warm up their shapes first).
    launches["bn"] = bn_act.LAUNCHES - bn_start
    print(f"[serve] phase 9 took {time.perf_counter() - start:.1f} s", flush=True)
    return launches


def serving_f32(work, ckpt, torch, Predictor, export_serving):
    """An f32 bundle of one bucket exported on the card against the same
    bundle exported on the CPU, TF32 off: argmax agreement."""
    import numpy as np

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        maps = {}
        img = np.random.RandomState(13).randint(0, 256, (448, 608, 3)).astype(np.uint8)
        for device in ("cuda", "cpu"):
            out = os.path.join(work, f"bundle_f32_{device}")
            export_serving.main(["--cfg", CFG, "--out", out, "--shapes", "448x608", "--batch",
                                 "1", "--device", device, "DIR", ckpt,
                                 "TPU.compute_dtype", "float32"])
            maps[device] = Predictor(out, device=device).predict(img)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    agree = float((maps["cuda"] == maps["cpu"]).mean())
    print(f"[serve] f32 bundle 1x448x608, card against CPU (TF32 off): argmax agreement "
          f"{agree:.6f} (limit {AGREE})", flush=True)
    if agree < AGREE:
        raise RuntimeError("the f32 bundle on the card disagrees with the CPU")


def _dp_batches(world):
    """Each of ``world`` ranks' host batch: one f32 image and its labels."""
    import numpy as np

    rng = np.random.RandomState(12)
    out = []
    for (h, w), void in DP_IMAGES[:world]:
        labels = rng.randint(0, 150, (1, h // 8, w // 8)).astype(np.int32)
        labels[rng.rand(*labels.shape) < void] = -1
        out.append({"img_data": rng.randn(1, h, w, 3).astype(np.float32), "seg_label": labels})
    return out


def _digest(tensors):
    import hashlib

    h = hashlib.sha256()
    for k, v in tensors.items():
        h.update(k.encode() + v.detach().cpu().contiguous().view(-1).numpy().tobytes())
    return h.hexdigest()


def _timed_steps(torch, state, batch, train_step, dropout_generator):
    """The first step, then DP_TIMED_STEPS timed ones; returns (the first
    step's loss and accuracy, its compared state, seconds of each timed
    step). Compared after the first step: in f32 later steps part (§8)."""
    m = train_step(state, batch, dropout_generator(0, 0))
    first = (float(m["loss"]), float(m["acc"]))
    params = dict(state.model.named_parameters())
    buffers = state.model.state_dict()
    snap = {"grads": {k: params[k].grad.to("cpu", copy=True) for k in DP_GRADS},
            "stats": {k: v.to("cpu", copy=True) for k, v in buffers.items() if "running" in k},
            "digest": _digest({**buffers, **{k + ".grad": p.grad for k, p in params.items()}})}
    seconds = []
    for i in range(1, 1 + DP_TIMED_STEPS):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        m = train_step(state, batch, dropout_generator(0, i))
        float(m["loss"])
        seconds.append(time.perf_counter() - tic)
    return first, snap, seconds


def _dp_rank(rank, port, out, devices, backend):
    """Rank ``rank`` of ``dp_ranks`` on ``devices[rank]`` (a spawned
    process)."""
    import torch
    import torch.distributed as dist

    from semseg_tpu_torch.ops.kernels import ppm_pool
    from semseg_tpu_torch.parallel import distributed, dropout_generator, train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = distributed.initialize(f"127.0.0.1:{port}", len(devices), rank, backend=backend,
                                    device=devices[rank], timeout=600)
    try:
        state = _train_model(torch, _cfg("TPU.compute_dtype", "float32"), device,
                             group=dist.group.WORLD)
        host = distributed._sync_batch_canvas(_dp_batches(len(devices))[rank],
                                              distributed.CanvasExchange("smoke"))
        batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        torch.cuda.synchronize()
        ppm_pool.LAUNCHES = ppm_pool.VALID_LAUNCHES = ppm_pool.BACKWARD_LAUNCHES = 0
        first, snap, seconds = _timed_steps(torch, state, batch, train_step, dropout_generator)
        launches = (ppm_pool.LAUNCHES, ppm_pool.VALID_LAUNCHES, ppm_pool.BACKWARD_LAUNCHES)
        # One more step under the profiler, on every rank (the collectives
        # need them all): its device kernel time, and the collectives' part.
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            float(train_step(state, batch, dropout_generator(0, 99))["loss"])
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        nccl = sum(e.self_device_time_total for e in kernels if "nccl" in e.key.lower()) / 1e3
        torch.save({"metrics": first, "seconds": seconds, "launches": launches,
                    "shape": tuple(host["img_data"].shape), "profile": (busy, nccl), **snap},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()


def dp_ranks(work, torch, card, devices, backend, tag):
    """Ranks on ``devices`` (one each) over ``backend``, one image each,
    against one process on ``CARD`` with the joined, padded batch: phase
    10 (a) (two gloo ranks on cuda:0) and the multi-card check (NCCL, a rank
    per card). Returns the ranks' launches."""
    import numpy as np

    from semseg_tpu_torch.parallel import distributed, dropout_generator, train_step

    world = len(devices)
    out = os.path.join(work, f"dp_ranks_{world}_{backend}")
    os.makedirs(out)
    torch.cuda.empty_cache()
    tic = time.perf_counter()
    torch.multiprocessing.spawn(_dp_rank, args=(distributed.free_port(), out, devices, backend),
                                nprocs=world)
    ranks_s = time.perf_counter() - tic
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(world)]
    steps = 1 + DP_TIMED_STEPS
    for r, got in enumerate(ranks):
        if got["launches"] != (steps, 0, steps):
            raise RuntimeError(f"rank {r}: pyramid_pool launches dense / valid / backward "
                               f"{got['launches']}, expected {steps} / 0 / {steps}")
        if got["digest"] != ranks[0]["digest"] or got["metrics"] != ranks[0]["metrics"]:
            raise RuntimeError(f"rank {r}'s state or metrics differ from rank 0's after the step")

    # One process, the same weights, the ranks' images padded to one canvas.
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    host = _dp_batches(world)
    joined = {}
    for k, v in (("img_data", 0.0), ("seg_label", -1)):
        hw = np.max([b[k].shape[1:3] for b in host], axis=0)
        joined[k] = np.concatenate([np.pad(b[k], [(0, 0), (0, hw[0] - b[k].shape[1]),
                                                  (0, hw[1] - b[k].shape[2])]
                                           + [(0, 0)] * (b[k].ndim - 3), constant_values=v)
                                    for b in host])
    if tuple(joined["img_data"].shape[1:]) != tuple(ranks[0]["shape"][1:]):
        raise RuntimeError(f"canvas {ranks[0]['shape']} against {joined['img_data'].shape}")
    state = _train_model(torch, _cfg("TPU.compute_dtype", "float32"), CARD)
    batch = {k: torch.from_numpy(v).to(CARD) for k, v in joined.items()}
    (loss, acc), snap, seconds = _timed_steps(torch, state, batch, train_step,
                                              dropout_generator)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    grads = {k: float((ranks[0]["grads"][k] - v).norm() / v.norm())
             for k, v in snap["grads"].items()}
    stat_rel, stat_key, iters_equal = 0.0, "", True
    for k, b in snap["stats"].items():
        a = ranks[0]["stats"][k]
        if k.endswith("_running_iter"):
            iters_equal = iters_equal and torch.equal(a, b)
            continue
        rel = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
        stat_rel, stat_key = max((stat_rel, stat_key), (rel, k))
    r_loss, r_acc = ranks[0]["metrics"]
    loss_rel = abs(r_loss - loss) / abs(loss)
    print(f"{tag} {world} {backend} ranks on {sorted(set(map(str, devices)))} (images "
          f"{[hw for hw, _ in DP_IMAGES[:world]]} padded to {ranks[0]['shape'][1:3]}), f32, "
          f"TF32 off, dropout on, against one process on {CARD} with the joined batch of "
          f"{world}: loss {r_loss:.6f} vs {loss:.6f}, "
          f"relative {loss_rel:.2e} (limit {LOSS_REL}); accuracy {r_acc:.6f} vs {acc:.6f} "
          f"(limit {DP_ACC}); gradients, relative norm error (limit {GRAD_REL}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in grads.items())
          + f"; BN statistics max |d| / max {stat_rel:.2e} ({stat_key}; limit {STAT_REL}); "
          f"iter equal {iters_equal}; all ranks' states bit-equal; per rank pyramid_pool "
          f"dense {ranks[0]['launches'][0]}, backward {ranks[0]['launches'][2]} over {steps} "
          f"steps", flush=True)
    busy, nccl = ranks[0]["profile"]
    print(f"{tag} timing, a smoke: {np.median(ranks[0]['seconds']) * 1e3:.1f} ms/step median "
          f"of {DP_TIMED_STEPS} for the {world} ranks (batch 1 each) against "
          f"{np.median(seconds) * 1e3:.1f} ms/step for one process at batch {world} (one "
          f"process cannot train at batch 1: the PPM's 1x1 grid has one value); rank 0's "
          f"profiled step: device kernels {busy:.1f} ms, of which NCCL kernels {nccl:.1f} ms; "
          f"the ranks' processes took "
          f"{ranks_s:.1f} s from spawn to exit (card: {card})", flush=True)
    if not (loss_rel < LOSS_REL and abs(r_acc - acc) < DP_ACC and stat_rel < STAT_REL
            and iters_equal and all(v < GRAD_REL for v in grads.values())):
        raise RuntimeError(f"{world} ranks disagree with one process")
    return {"dense": sum(r["launches"][0] for r in ranks),
            "backward": sum(r["launches"][2] for r in ranks)}


def dp_nccl_world_of_one(torch, ppm_pool, train_root, train_odgt, work, card):
    """Phase 10 (b): ``cli.train --multihost`` as a world of 1 on NCCL, from
    the SEMSEG_* variables, against two single-card ``cli.train`` runs on
    phase 8's data and settings (one loader worker, so that the runs see
    one batch order; every step logged). Returns its launches."""
    import torch.distributed as dist

    from semseg_tpu_torch.cli import train as train_cli
    from semseg_tpu_torch.parallel import distributed

    opts = [*_train_cfg_opts(train_root, train_odgt), "TRAIN.num_epoch", "1",
            "TRAIN.disp_iter", "1", "TRAIN.workers", "1"]
    backends = []
    initialize = distributed.initialize

    def spy(*args, **kwargs):
        device = initialize(*args, **kwargs)
        backends.append(dist.get_backend())
        return device

    losses = {}
    env = {"SEMSEG_COORDINATOR": f"127.0.0.1:{distributed.free_port()}",
           "SEMSEG_NUM_PROCESSES": "1", "SEMSEG_PROCESS_ID": "0"}
    # One card each (cli.train's default takes every visible card).
    runs = [("single card A", ["--devices", "1"]), ("single card B", ["--devices", "1"]),
            ("--multihost NCCL world of 1", ["--multihost"])]
    while runs:
        name, flags = runs.pop(0)
        out = os.path.join(work, "dp_" + name.split()[-1])
        multihost = "--multihost" in flags
        if multihost:
            os.environ.update(env)
            distributed.initialize = spy
        try:
            (_, history), seconds, dense, valid = _run_path(
                f"cli.train {name}", lambda: train_cli.main(
                    ["--cfg", CFG, *flags, "DIR", out, *opts]), ppm_pool, torch,
                backward=TRAIN_ITERS)
        finally:
            if multihost:
                distributed.initialize = initialize
                for k in env:
                    del os.environ[k]
        if (dense, valid) != (TRAIN_ITERS, 0):
            raise RuntimeError(f"cli.train {name}: launches dense {dense} / valid {valid}")
        losses[name] = history["train"]["loss"]
        print(f"[dp] (b) cli.train {name}: per-step losses {losses[name]} ({seconds:.1f} s "
              f"wall; card: {card})", flush=True)
        if name.endswith("B") and losses[name] != losses["single card A"]:
            runs.insert(0, ("single card C", ["--devices", "1"]))
    m = losses.pop("--multihost NCCL world of 1")
    singles = list(losses.values())

    def distance(p, q):
        return max(abs(x - y) for x, y in zip(p, q))

    spread = max(distance(p, q) for i, p in enumerate(singles) for q in singles[i + 1:])
    nearest = min(distance(p, m) for p in singles)
    # A world of 1 does the single card's arithmetic, so it must repeat its
    # losses bit for bit where two single-card runs do. Otherwise (the
    # backward's atomic adds order differently from run to run) the first
    # step is still bit-equal (a forward), and the nearest of three
    # single-card runs lies within 3x the largest distance between two of
    # them (with independent normal run-to-run noise that fails 0.2% of
    # correct runs; twice, 1.2%).
    first_equal = all(p[0] == m[0] for p in singles)
    print(f"[dp] (b) backend in use {backends}; run-to-run spread (max |d| per step) of "
          f"{len(singles)} single-card runs {spread:.3e}; the NCCL world of 1 against the "
          f"nearest {nearest:.3e} (limit {3 * spread:.3e}); first step bit-equal "
          f"{first_equal}", flush=True)
    if backends != ["nccl" if CARD == "cuda" else "gloo"] or len(m) != TRAIN_ITERS \
            or not first_equal or nearest > 3 * spread:
        raise RuntimeError(f"cli.train --multihost: backend {backends}, losses {m} against "
                           f"the single-card runs' {singles} (spread {spread})")
    if dist.is_initialized():
        raise RuntimeError("cli.train --multihost left its process group behind")
    return {"dense": TRAIN_ITERS, "backward": TRAIN_ITERS}


def _count_calls(engine, name, counts, i):
    real = getattr(engine, name)

    def counted(*args, **kwargs):
        counts[i] += 1
        return real(*args, **kwargs)

    setattr(engine, name, counted)


def dp_two_engines(ckpt, val_dir, odgt, torch, ppm_pool, card):
    """Phase 10 (c): ``cli.eval``'s engines, one and two on cuda:0, through
    ``build_engines``' device list: ``--exact`` sums equal, the default
    batched path within PARITY.md's bucketed bar. Returns the two-engine
    runs' launches."""
    import logging

    import numpy as np

    from semseg_tpu_torch.checkpoint import resolve_reference_checkpoint
    from semseg_tpu_torch.cli import eval as eval_cli

    cfg = _cfg("DIR", ckpt, "DATASET.root_dataset", val_dir, "DATASET.list_val", odgt)
    resolve_reference_checkpoint(cfg, cfg.VAL.checkpoint)
    logger = logging.getLogger("dp-eval")
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    n_scales = len(cfg.DATASET.imgSizes)
    results, launches = {}, {"dense": 0, "valid": 0}
    for mode, kw, method in (("exact", dict(exact=True), "predict"),
                             ("batched", dict(batch=4, fetch_dtype="bfloat16",
                                              pack_buckets=True), "batched_metrics")):
        device = "cuda:0" if CARD == "cuda" else CARD
        for devices in ([device], [device, device]):
            engines = eval_cli.build_engines(cfg, devices=devices, **kw)
            calls = [0] * len(engines)
            for i, e in enumerate(engines):
                _count_calls(e, method, calls, i)
            chunk = eval_cli.CHUNK
            if len(engines) > 1:
                eval_cli.CHUNK = DP_EVAL_CHUNK
            try:
                loader = eval_cli.make_loader(cfg, engines, exact=mode == "exact")
                (miou, acc, _, raw), seconds, dense, valid = _run_path(
                    f"{mode} eval on {len(engines)} engine(s)", lambda: eval_cli.evaluate(
                        engines, loader, cfg, logger), ppm_pool, torch)
                calls_per = eval_cli.CHUNK
            finally:
                eval_cli.CHUNK = chunk
            want = ((len(EVAL_IMAGES) * n_scales, 0) if mode == "exact" else
                    (0, expected_chunks(cfg, val_dir, odgt, flagship=False, calls=calls_per)))
            if (dense, valid) != want:
                raise RuntimeError(f"{mode} eval on {len(engines)} engine(s): launches "
                                   f"{dense} / {valid}, expected {want}")
            if len(engines) > 1:
                launches["dense"] += dense
                launches["valid"] += valid
            results[mode, len(engines)] = (miou, raw)
            print(f"[dp] (c) {mode} eval on {devices}: mIoU {miou:.6f}, accuracy "
                  f"{acc * 100:.4f}%, {raw['pix_count']:.0f} pixels; calls per engine {calls}; "
                  f"pyramid_pool dense {dense}, valid_hw {valid}; {seconds:.1f} s wall "
                  f"(card: {card})", flush=True)
            if mode == "exact" and min(calls) == 0:
                raise RuntimeError(f"an engine took no image: {calls}")
    (_, one), (_, two) = results["exact", 1], results["exact", 2]
    equal = all(np.array_equal(one[k], two[k]) for k in ("inter", "union", "pix_count"))
    acc_rel = abs(one["acc_sum"] - two["acc_sum"]) / one["acc_sum"]
    d_miou = abs(results["batched", 1][0] - results["batched", 2][0])
    print(f"[dp] (c) --exact sums, two engines against one: intersection, union and pixels "
          f"equal {equal}, accuracy sum relative {acc_rel:.1e} (float sums in thread order); "
          f"batched mIoU |d| {d_miou:.2e} (limit {BUCKETED_MIOU})", flush=True)
    if not (equal and acc_rel < 1e-12 and d_miou <= BUCKETED_MIOU):
        raise RuntimeError("two engines on one card disagree with one engine")
    return launches


def data_parallel_phase(work, torch, ppm_pool, card, ckpt, val_dir, odgt, train_root,
                        train_odgt):
    """Phase 10: data parallel on one card, (a)-(c). Returns its launches."""
    start = time.perf_counter()
    device = "cuda:0" if CARD == "cuda" else CARD
    a = dp_ranks(work, torch, card, [device, device], "gloo",
                 "[dp] (a) (gloo through the host, ranks sharing one card)")
    b = dp_nccl_world_of_one(torch, ppm_pool, train_root, train_odgt, work, card)
    c = dp_two_engines(ckpt, val_dir, odgt, torch, ppm_pool, card)
    print(f"[dp] phase 10 took {time.perf_counter() - start:.1f} s (card: {card})", flush=True)
    return {"dense": a["dense"] + b["dense"] + c["dense"], "valid": c["valid"],
            "backward": a["backward"] + b["backward"]}


def multi_card_phase(work, torch, ppm_pool, card, ckpt, val_dir, odgt, train_root,
                     train_odgt, zoo_ckpts):
    """With more than one visible card: a rank per card over NCCL. The ranks
    against one process (as phase 10 (a)); ``cli.train --devices N`` for one
    epoch on phase 8's data (rank 0 writes the checkpoint); ``cli.eval
    --exact`` on N engines against one engine (the sums equal); ``cli.serve
    --devices N``, a backend per card, over phase 9's bundle (exported on
    card 0) and the live engine (as phase 11 (c))."""
    import numpy as np

    from semseg_tpu_torch.cli import eval as eval_cli, train as train_cli

    n = torch.cuda.device_count()
    start = time.perf_counter()
    dp_ranks(work, torch, card, [f"cuda:{r}" for r in range(n)], "nccl", "[multi]")

    out = os.path.join(work, "multi_train")
    tic = time.perf_counter()
    result = train_cli.main(["--cfg", CFG, "--devices", str(n), "DIR", out,
                             *_train_cfg_opts(train_root, train_odgt), "TRAIN.num_epoch", "1",
                             "TRAIN.disp_iter", "1", "TRAIN.workers", "1"])
    wall = time.perf_counter() - tic
    with open(os.path.join(out, "history_epoch_1.json")) as f:
        losses = json.load(f)["train"]["loss"]
    if result is not None or len(losses) != TRAIN_ITERS or not np.all(np.isfinite(losses)) \
            or not os.path.exists(os.path.join(out, "encoder_epoch_1.pth")):
        raise RuntimeError(f"cli.train --devices {n}: result {result}, losses {losses}")
    print(f"[multi] cli.train --devices {n}: {TRAIN_ITERS} steps at batch 2 per card (global "
          f"{2 * n}), bf16, full width; per-step global losses {losses}; {wall:.1f} s wall "
          f"(spawn, model builds and the checkpoint included; card: {card})", flush=True)

    data = ["DIR", ckpt, "DATASET.root_dataset", val_dir, "DATASET.list_val", odgt]
    raws = {}
    for devices in (1, n):
        tic = time.perf_counter()
        raws[devices] = eval_cli.main(["--cfg", CFG, "--exact", "--devices", str(devices),
                                       *data])[3]
        print(f"[multi] cli.eval --exact --devices {devices}: {time.perf_counter() - tic:.1f} "
              f"s wall for {len(EVAL_IMAGES)} images (model builds included; card: {card})",
              flush=True)
    one, many = raws[1], raws[n]
    if not (all(np.array_equal(one[k], many[k]) for k in ("inter", "union", "pix_count"))
            and abs(one["acc_sum"] - many["acc_sum"]) <= 1e-12 * one["acc_sum"]):
        raise RuntimeError(f"cli.eval --exact on {n} cards disagrees with one card")
    print(f"[multi] --exact sums on {n} engines (one per card) equal one engine's",
          flush=True)
    serve_devices_phase(work, ckpt, torch, ppm_pool, card, devices=n)
    spatial_multi_card(ckpt, val_dir, odgt, torch, card, n)
    spatial_train_multi_card(work, torch, ppm_pool, card, train_root, train_odgt, n)
    zoo_spatial_multi_card(zoo_ckpts, val_dir, odgt, torch, card, n)
    spatial_remat_multi_card(work, torch, ppm_pool, card, train_root, train_odgt, n)
    print(f"[multi] the multi-card phase took {time.perf_counter() - start:.1f} s (card: "
          f"{card})", flush=True)


# Phase 11: the slice's modules. (a) the native host library: JPEG decode
# and the pyramid bit-equal to PIL on phase 8's and the val set's images, a
# TrainDataset batch equal to the PIL path's, host times on one thread;
# (b) TPU.remat: two f32 steps bit-equal to the plain run under
# deterministic algorithms, BN's iter too, then bench.py's batch-8 step
# both ways (ms/step, peak memory); (c) cli.serve --devices 2 on one card,
# bundle and live, at 1 and 4 clients with phase 9's requests (the live
# engine, 5 scales per request, the first half) and rules; (d) cli.eval
# --profile on two val images.
HOST_TIMED_BATCHES = 10  # TrainDataset batches per path, after one warm-up
HOST_TIMED_PASSES = 3  # pyramid passes over the originals per path
REMAT_TIMED = (3, 5)  # runs x steps of bench.py's step per setting
SLICE_CONCURRENCY = (1, 4)


class _NoNative:
    """``SEMSEG_NO_NATIVE=1`` while entered: the data layer's PIL path."""

    def __enter__(self):
        os.environ["SEMSEG_NO_NATIVE"] = "1"

    def __exit__(self, *exc):
        del os.environ["SEMSEG_NO_NATIVE"]


def native_phase(train_root, train_odgt, val_dir, odgt, card):
    """(a): the build, bit-equality with PIL, host times on one thread."""
    import contextlib

    import numpy as np
    from PIL import Image

    from semseg_tpu_torch import native
    from semseg_tpu_torch.data import PyramidBuilder, TrainDataset, parse_odgt

    available, info, jpeg = native.available(), native.build_info(), native.jpeg_available()
    print(f"[native] g++ command: {info.get('command')}; library {info.get('library')} "
          f"({'compiled by this process' if info.get('built') else 'found built'}); libjpeg "
          + ("found" if jpeg else "NOT FOUND: JPEGs decode with PIL and "
             "TPU.train_fast_decode decodes exactly")
          + f"; available() {available}, jpeg_available() {jpeg}", flush=True)
    if not available:
        raise RuntimeError(f"the native library did not build on this host: {info}")

    cfg = _cfg()
    builder = PyramidBuilder(cfg.DATASET, bucket_step=cfg.TPU.eval_bucket_step)
    files = ([os.path.join(train_root, r["fpath_img"]) for r in parse_odgt(train_odgt)]
             + [os.path.join(val_dir, r["fpath_img"]) for r in parse_odgt(odgt)])
    oris = []
    for path in files:
        pil = np.asarray(Image.open(path).convert("RGB"))
        oris.append(pil)
        if jpeg:
            with open(path, "rb") as f:
                got = native.decode_jpeg_verified(f.read())
            if got is None or not np.array_equal(got, pil):
                raise RuntimeError(f"{path}: the native decode differs from PIL's")
        levels = builder.multi_scale_pyramid(pil, raw=True)
        with _NoNative():
            want = builder.multi_scale_pyramid(pil, raw=True)
        if not all(np.array_equal(a, b) for a, b in zip(levels, want)):
            raise RuntimeError(f"{path}: a native pyramid level differs from PIL's")
    print(f"[native] {len(files)} JPEGs (phase 8's training set and the val set): "
          + ("decode_jpeg_verified bit-equal to PIL, " if jpeg else "")
          + "the 5-level uint8 pyramid (step 8) bit-equal to PIL's", flush=True)

    tcfg = _cfg(*_train_cfg_opts(train_root, train_odgt))

    def batches(n, **kw):
        ds = TrainDataset(train_root, train_odgt, tcfg.DATASET, batch_per_gpu=2, seed=5,
                          bucket_step=tcfg.TPU.bucket_step, **kw)
        return [ds.next_batch() for _ in range(n)]

    worst = 0.0
    for raw in (True, False):
        got = batches(4, raw_transport=raw)
        with _NoNative():
            want = batches(4, raw_transport=raw)
        for a, b in zip(got, want):
            if not (np.array_equal(a["seg_label"], b["seg_label"])
                    and a["img_data"].shape == b["img_data"].shape):
                raise RuntimeError("a native TrainDataset batch differs from the PIL path's")
            d = float(np.abs(a["img_data"].astype(np.float64) - b["img_data"]).max())
            if (raw and d) or d > 1e-6:
                raise RuntimeError(f"native TrainDataset images differ from PIL's by {d}")
            worst = max(worst, d)
    print(f"[native] TrainDataset, 4 batches of 2, native against SEMSEG_NO_NATIVE=1 (seed "
          f"5): labels equal, uint8 images bit-equal, float32 images max |d| {worst:.2e} "
          f"(limit 1e-6, the JAX package's test)", flush=True)

    def pyramid_s(no_native):
        runs = []
        for _ in range(HOST_TIMED_PASSES):
            with _NoNative() if no_native else contextlib.nullcontext():
                tic = time.perf_counter()
                for ori in oris:
                    builder.multi_scale_pyramid(ori, raw=True)
            runs.append((time.perf_counter() - tic) / len(oris))
        return sorted(runs)[len(runs) // 2]

    def batch_s(no_native, **kw):
        with _NoNative() if no_native else contextlib.nullcontext():
            ds = TrainDataset(train_root, train_odgt, tcfg.DATASET, batch_per_gpu=2, seed=6,
                              bucket_step=tcfg.TPU.bucket_step, raw_transport=True, **kw)
            ds.next_batch()
            tic = time.perf_counter()
            for _ in range(HOST_TIMED_BATCHES):
                ds.next_batch()
        return (time.perf_counter() - tic) / HOST_TIMED_BATCHES

    def resize_ms(fn, arrays):
        """ms per resize of each array to 3/4 of its size."""
        tic = time.perf_counter()
        for _ in range(HOST_TIMED_PASSES):
            for a in arrays:
                fn(a, (a.shape[0] * 3 // 4, a.shape[1] * 3 // 4))
        return (time.perf_counter() - tic) / (HOST_TIMED_PASSES * len(arrays)) * 1e3

    labels = [np.asarray(Image.open(os.path.join(train_root, r["fpath_segm"])))
              for r in parse_odgt(train_odgt)]
    pil_resize = {kind: lambda a, hw, k=kind: Image.fromarray(a).resize(hw[::-1], k)
                  for kind in (Image.BILINEAR, Image.NEAREST)}
    print(f"[native] one resize to 3/4 size, one thread: bilinear (the RGB originals) PIL "
          f"{resize_ms(pil_resize[Image.BILINEAR], oris):.3f} / native "
          f"{resize_ms(native.resize_bilinear_u8, oris):.3f} ms; nearest (phase 8's label "
          f"maps) PIL {resize_ms(pil_resize[Image.NEAREST], labels):.3f} / native "
          f"{resize_ms(native.resize_nearest_u8, labels):.3f} ms", flush=True)
    pil_pyr, nat_pyr = pyramid_s(True), pyramid_s(False)
    pil_b, nat_b = batch_s(True), batch_s(False)
    fast_b = batch_s(False, fast_decode=True)
    print(f"[native] host times on one thread of this machine's CPU ({os.cpu_count()} cores "
          f"visible): pyramid (5 uint8 levels, step 8) PIL {pil_pyr:.4f} / native "
          f"{nat_pyr:.4f} s/image ({pil_pyr / nat_pyr:.2f}x), median of {HOST_TIMED_PASSES} "
          f"passes over {len(oris)} originals; TrainDataset batch of 2 (uint8, decode + "
          f"resize + labels) PIL {pil_b:.4f} / native {nat_b:.4f} ({pil_b / nat_b:.2f}x) / "
          f"native fast_decode {fast_b:.4f} s/batch ({pil_b / fast_b:.2f}x"
          + ("" if jpeg else ", no libjpeg: the exact decode")
          + f"), mean of {HOST_TIMED_BATCHES} batches (card: {card})", flush=True)


def remat_phase(torch, ppm_pool, card):
    """(b): TPU.remat on against off on the card. Returns its launches.

    The two float32 runs go under deterministic algorithms: with the card's
    default ones two plain runs differ by as much as remat and plain do, so
    a check with tolerances reads the card's rounding and fails at random;
    deterministic, remat must give the plain run's bits."""
    import numpy as np

    from semseg_tpu_torch.models.layers import BatchNorm2d
    from semseg_tpu_torch.parallel import dropout_generator, train_step

    launches = {"dense": 0, "valid": 0, "backward": 0}
    rng = np.random.RandomState(14)
    n, h, w = 2, 256, 320
    host = [{"img_data": rng.randn(n, h, w, 3).astype(np.float32),
             "seg_label": rng.randint(-1, 150, (n, h // 8, w // 8)).astype(np.int32)}
            for _ in range(2)]
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    try:
        with _deterministic(torch):
            for remat in (False, True):
                state = _train_model(torch, _cfg("TPU.compute_dtype", "float32",
                                                 "TPU.remat", str(remat)), CARD)
                batches = [{k: torch.from_numpy(v).to(CARD) for k, v in b.items()}
                           for b in host]

                def steps():
                    return [{k: float(v) for k, v in train_step(
                        state, b, dropout_generator(0, i)).items()}
                        for i, b in enumerate(batches)]

                metrics, _, dense, valid = _run_path(
                    f"remat {'on' if remat else 'off'}: 2 float32 train steps", steps,
                    ppm_pool, torch, backward=2)
                if (dense, valid) != (2, 0):
                    raise RuntimeError(f"remat {remat}: pool launches {dense} / {valid}")
                launches["dense"] += dense
                launches["backward"] += 2
                runs[remat] = (state, metrics)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    (plain, pm), (remat, rm) = runs[False], runs[True]
    params, buffers = dict(plain.model.named_parameters()), dict(plain.model.named_buffers())
    grad_rel = {k: float((p.grad - params[k].grad).norm() / params[k].grad.norm())
                for k, p in remat.model.named_parameters() if k in DP_GRADS}
    differ = ([f"{k} (value)" for k, p in remat.model.named_parameters()
               if not torch.equal(p, params[k])]
              + [f"{k} (gradient)" for k, p in remat.model.named_parameters()
                 if not torch.equal(p.grad, params[k].grad)]
              + [k for k, b in remat.model.named_buffers() if not torch.equal(b, buffers[k])])
    n_bn = sum(isinstance(m, BatchNorm2d) for m in remat.model.modules())
    it = float(remat.model.encoder.layer4[2].bn3._running_iter)
    print(f"[remat] flagship f32 (TF32 off, deterministic algorithms), batch {n} {h}x{w}, 2 "
          f"steps, TPU.remat on against off from the same weights and batches: losses "
          f"{[m['loss'] for m in rm]} / {[m['loss'] for m in pm]}, accuracies "
          f"{[m['acc'] for m in rm]} / {[m['acc'] for m in pm]}; gradients relative norm "
          + ", ".join(f"{k} {v:.3e}" for k, v in grad_rel.items())
          + f"; {len(params)} parameters with their gradients and {len(buffers)} buffers "
          f"({n_bn} BNs' running statistics and iter): {len(differ)} differ "
          f"{differ[:5]} (layer4.2.bn3 iter {it:.6f}, two updates: 2.997001)", flush=True)
    if rm != pm or differ or len(grad_rel) != len(DP_GRADS) or abs(it - 2.997001) >= 1e-5:
        raise RuntimeError("TPU.remat: the remat step departs from the plain one")
    del plain, remat, runs, params, state, batches
    torch.cuda.empty_cache()

    bs, h, w = BENCH_TRAIN
    rng = np.random.RandomState(0)
    batch = {"img_data": torch.from_numpy(rng.randn(bs, h, w, 3).astype(np.float32)).to(CARD),
             "seg_label": torch.from_numpy(
                 rng.randint(-1, 150, (bs, h // 8, w // 8)).astype(np.int32)).to(CARD)}
    out = {}
    n_runs, n_steps = REMAT_TIMED
    for remat in (False, True):
        state = _train_model(torch, _cfg("TPU.remat", str(remat)), CARD)

        def timed():
            float(train_step(state, batch, dropout_generator(0, state.step))["loss"])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated() / 2**30
            times = []
            for _ in range(n_runs):
                tic = time.perf_counter()
                for _ in range(n_steps):
                    m = train_step(state, batch, dropout_generator(0, state.step))
                loss = float(m["loss"])
                times.append((time.perf_counter() - tic) / n_steps)
            if not np.isfinite(loss):
                raise RuntimeError(f"remat {remat}: non-finite loss {loss}")
            return sorted(times), torch.cuda.max_memory_allocated() / 2**30, base

        steps = 1 + n_runs * n_steps
        (times, peak, base), _, dense, _ = _run_path(
            f"remat {'on' if remat else 'off'}: bench.py's train step", timed, ppm_pool, torch,
            backward=steps)
        launches["dense"] += dense
        launches["backward"] += steps
        out[remat] = (times[0], times[len(times) // 2], peak, base)
        del state
        torch.cuda.empty_cache()
    (pb, pmed, ppeak, pbase), (rb, rmed, rpeak, rbase) = out[False], out[True]
    print(f"[remat] bench.py's train step, flagship bf16, batch {bs} {h}x{w}, {n_runs} x "
          f"{n_steps} steps: remat off {pb * 1e3:.1f} ms best / {pmed * 1e3:.1f} median, peak "
          f"{ppeak:.2f} GiB; remat on {rb * 1e3:.1f} / {rmed * 1e3:.1f} ms, peak {rpeak:.2f} "
          f"GiB (allocated between steps: {pbase:.2f} / {rbase:.2f} GiB, the weights, "
          f"gradients, momentum and the batch); remat/plain: time {rmed / pmed:.3f}x, peak "
          f"memory {rpeak / ppeak:.3f}x, peak above that {(rpeak - rbase) / (ppeak - pbase):.3f}x "
          f"(card: {card})", flush=True)
    if not rpeak < ppeak:
        raise RuntimeError(f"TPU.remat did not lower the peak: {rpeak} against {ppeak} GiB")
    return launches


def serve_devices_phase(work, ckpt, torch, ppm_pool, card, devices=None):
    """(c): ``cli.serve --devices N`` over phase 9's bundle (exported on
    card 0) and over the live engine, phase 9's requests at 1 and 4
    clients: at one client each map equals the map one backend gives its
    request alone, at 4 the bundle's map equals its request's at the slots
    it was served in and the live map is closest to its own request.
    ``devices`` None: two backends on cuda:0; else ``--devices N`` over the
    cards. Returns the launches."""
    from semseg_tpu_torch.cli import serve as serve_cli

    if devices is None:
        flags, n = ["--device", "cuda:0", "--devices", "2"], 2
    else:
        flags, n = ["--devices", str(devices)], devices
    tag = f"--devices {n}" + (" on cuda:0" if devices is None else "")
    bodies, decoded = _serve_requests()
    launches = {"dense": 0, "valid": 0}
    common = ["--host", "127.0.0.1", "--port", "0", "--quiet", *flags]
    for backend in ("bundle", "live"):
        if backend == "bundle":
            server, preds = serve_cli.build_server(
                [*common, "--bundle", os.path.join(work, "bundle"), "--max-batch",
                 str(SERVE_BATCH)])
            lone = [preds[0].predict(d) for d in decoded]
            record = _SlotRecord(preds[0], decoded)
            for pred in preds[1:]:
                for key, program in list(pred.programs.items()):
                    pred.programs[key] = record._recorded(program)
            agree = AGREE
            where = [str(p.device) for p in preds]
        else:
            # Half the requests: the live engine runs 5 scales per request.
            bodies, decoded = bodies[:SERVE_REQUESTS // 2], decoded[:SERVE_REQUESTS // 2]
            server, preds = serve_cli.build_server(
                [*common, "--cfg", CFG, "--max-batch", "8", "DIR", ckpt])
            lone = [preds[0].predict_batch([d])[0] for d in decoded]
            record, agree = None, None
            where = [str(p._engine.device) for p in preds]
        if len(preds) != n or server.info["devices"] != n:
            raise RuntimeError(f"{tag}: {len(preds)} backends, info {server.info}")
        try:
            (batches, per_backend), _, dense, valid = _run_path(
                f"cli.serve --{backend} {tag} traffic", lambda: _serve_traffic(
                    f"{backend} {tag}", server, bodies, lone, agree, card, record,
                    concurrency=SLICE_CONCURRENCY), ppm_pool, torch)
        finally:
            server.close()
        print(f"[serve] {backend} {tag}: backends on {where}, batches per backend over the "
              f"rounds {per_backend}", flush=True)
        if not per_backend or min(per_backend) == 0:
            raise RuntimeError(f"{backend} {tag}: a backend took no batch: {per_backend}")
        if backend == "bundle" and not (batches <= dense <= 2 * batches and valid == 0):
            raise RuntimeError(f"bundle {tag}: {batches} batches, launches {dense} / {valid}")
        if backend == "live" and (dense or not valid):
            raise RuntimeError(f"live {tag}: launches dense {dense} / valid {valid}")
        launches["dense"] += dense
        launches["valid"] += valid
    return launches


def eval_profile_phase(work, ckpt, val_dir, odgt, torch, ppm_pool, card):
    """(d): ``cli.eval --profile`` over the first two val images; the trace
    names the pad-aware pool's kernels. Returns the launches."""
    from semseg_tpu_torch.cli import eval as eval_cli

    two = os.path.join(val_dir, "two.odgt")
    with open(odgt) as f, open(two, "w") as g:
        g.writelines(f.readlines()[:2])
    trace_dir = os.path.join(work, "eval_profile")
    data = ["DIR", ckpt, "DATASET.root_dataset", val_dir, "DATASET.list_val", two]
    chunks = expected_chunks(_cfg(*data), val_dir, two, flagship=False)
    (miou, _, _, raw), seconds, dense, valid = _run_path(
        "cli.eval --profile, 2 images", lambda: eval_cli.main(
            ["--cfg", CFG, "--profile", trace_dir, *data]), ppm_pool, torch)
    path = os.path.join(trace_dir, "eval_trace.json")
    with open(path) as f:
        names = {e.get("name") or "" for e in json.load(f)["traceEvents"]}
    pool = sorted(n for n in names if any(k in n for k in FORWARD_KERNELS))
    # The pad-aware form's combine: ppm_combine_kernel<T, kValid = true>.
    valid_kernels = [n for n in pool if re.search(r"ppm_combine_kernel<[^<>]*, true>", n)]
    print(f"[profile] cli.eval --profile over 2 images: {os.path.getsize(path) / 1e6:.1f} MB "
          f"trace, {len(names)} distinct event names, {seconds:.1f} s wall; pool kernels in "
          f"it: {[n[:70] for n in pool]}; mIoU {miou:.4f} (card: {card})", flush=True)
    if (dense, valid) != (0, chunks) or not valid_kernels or not raw["pix_count"]:
        raise RuntimeError(f"cli.eval --profile: launches {dense} / {valid} (expected 0 / "
                           f"{chunks}), pad-aware kernels in the trace {valid_kernels}")
    return {"dense": dense, "valid": valid}


def slice_phase(work, torch, ppm_pool, card, ckpt, val_dir, odgt, train_root, train_odgt):
    """Phase 11: (a)-(d) above. Returns the launches."""
    start = time.perf_counter()
    native_phase(train_root, train_odgt, val_dir, odgt, card)
    launches = remat_phase(torch, ppm_pool, card)
    for more in (serve_devices_phase(work, ckpt, torch, ppm_pool, card),
                 eval_profile_phase(work, ckpt, val_dir, odgt, torch, ppm_pool, card)):
        for form, count in more.items():
            launches[form] += count
    print(f"[slice] phase 11 took {time.perf_counter() - start:.1f} s (card: {card})",
          flush=True)
    return launches

# Phase 12: spatial (``cli.eval --spatial``). (a) the band form of the pool
# against its plain version, then timed; (b) the flagship split in 2 and 4
# bands on cuda:0 against the unsplit bucketed engine; (c) ``cli.eval
# --spatial 2`` end to end.
# (shape, extents, row cuts): the flagship's conv5 in 2 and 4 bands; odd C
# with bands of one row and bins straddling bands; an empty extent and one
# of a few rows. The first case also runs on a map whose address is one
# element past a 16-byte boundary.
BAND_CHECKS = [
    ((1, 75, 100, 2048), [[75, 100]], (0, 38, 75)),
    ((1, 75, 100, 2048), [[75, 100]], (0, 19, 38, 57, 75)),
    ((2, 38, 50, 250), [[38, 50], [21, 33]], (0, 1, 2, 13, 37, 38)),
    ((3, 13, 17, 2048), [[13, 17], [0, 0], [3, 9]], (0, 6, 7, 13)),
]
# A band's sums against the plain version's: f32 sums of up to 7,500
# elements of unit scale in another order.
BAND_SUM_TOL = dict(atol=1e-3, rtol=1e-5)
SPATIAL_BANDS = (2, 4)
SPATIAL_SCORE = 2e-4  # tests/test_engine.py:209, 4 devices against one
SPATIAL_AGREE = 0.99  # bf16: cuDNN's choices per band shape round apart


def check_band_kernel(ppm_pool, torch, checks=BAND_CHECKS, tag="[spatial]") -> float:
    """(a): every band of each case of ``checks`` against the plain
    version, each launch repeated bit for bit, the bands' sums as grids
    against the pad-aware form; the first case also on a map one element
    past a 16-byte boundary. Returns the largest absolute difference of a
    band's sums."""
    import numpy as np

    max_err = 0.0
    g = torch.Generator(device="cuda").manual_seed(12)
    cases = [(*c, False) for c in checks] + [(*checks[0], True)]
    for shape, extents, cuts, unaligned in cases:
        v = torch.tensor(extents, dtype=torch.int32, device="cuda")
        h = shape[1]
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            if unaligned:
                flat = torch.randn(int(np.prod(shape)) + 1, generator=g, device="cuda")
                x = flat.to(dtype)[1:].view(shape)
            else:
                x = torch.randn(shape, generator=g, device="cuda").to(dtype)
            total, ptrs = None, []
            for a, b in zip(cuts, cuts[1:]):
                band = x[:, a:b] if shape[0] == 1 else x[:, a:b].contiguous()
                ptrs.append(band.data_ptr() % 16)
                sums = ppm_pool.pyramid_pool_band(band, v, a, h)
                if not torch.equal(sums, ppm_pool.pyramid_pool_band(band, v, a, h)):
                    raise RuntimeError(f"pyramid_pool_band {shape} rows [{a}, {b}): two "
                                       "launches differ")
                ref = ppm_pool.pyramid_pool_band_plain(band, v, a, h)
                torch.testing.assert_close(sums, ref, **BAND_SUM_TOL)
                max_err = max(max_err, (sums - ref).abs().max().item())
                total = sums if total is None else total + sums
            grids = ppm_pool.band_sums_to_grids(total, v, shape[1:3], dtype)
            grid_err = 0.0
            for o, r in zip(grids, ppm_pool.pyramid_pool_plain(x, valid_hw=v)):
                torch.testing.assert_close(o.float(), r.float(), **_valid_tolerance(dtype))
                grid_err = max(grid_err, (o.float() - r.float()).abs().max().item())
            print(f"{tag} pyramid_pool_band {shape} {dt} extents {extents} rows {cuts}"
                  f"{', data_ptr % 16 = ' + str(ptrs) if unaligned else ''}: ok, each band's "
                  f"two launches bit-equal; grids from the summed bands vs the pad-aware "
                  f"plain form max |d| {grid_err:.3e}", flush=True)
    torch.cuda.synchronize()
    return max_err


def band_bound_ms(shape, element_size):
    """Least time of one band launch on an H100 SXM at full extents: the
    band read once, 50 f32 sums per channel and the extents written or read
    once, over 3.35 TB/s, against one f32 add per element at 67 TFLOP/s."""
    n, hb, w, c = shape
    moved = n * hb * w * c * element_size + n * 50 * c * 4 + 8 * n
    by_bytes, by_ops = moved / HBM_BYTES_PER_S * 1e3, n * hb * w * c / 67e12 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def time_band_kernel(ppm_pool, torch, card, compare=None, shape=MAIN_SHAPE, base=8) -> dict:
    """(a), timed: a conv5 map of ``shape`` (by default the flagship's, (1,
    75, 100, 2048)) cut as its canvas's stride-``base`` rows into 2 and 4
    bands (``BandPlan``): the first band's launch warm and L2-cold, its
    plain version, all bands in turn on one card, and the pad-aware form
    on the whole map, cold; one kernel launch per call under the profiler.
    With ``compare``, the other build in turns. Returns {(bands, dtype):
    (warm, cold, plain, bound, bound_by)}."""
    from semseg_tpu_torch.parallel.spatial import BandPlan

    flush = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    h = shape[1]
    v = torch.tensor([list(shape[1:3])] * shape[0], dtype=torch.int32, device="cuda")
    out = {}
    for bands in SPATIAL_BANDS:
        rows = BandPlan(base * h, bands, base).rows(base)
        for dt in ("bfloat16", "float32"):
            x = torch.randn(shape, device="cuda").to(getattr(torch, dt))
            parts = [(x[:, a:b], a) for a, b in rows]
            band, r0 = parts[0]

            def one():
                return ppm_pool.pyramid_pool_band(band, v, r0, h)

            def all_bands():
                return [ppm_pool.pyramid_pool_band(p, v, a, h) for p, a in parts]

            warm = _median_ms(one, torch)
            cold = _median_ms(one, torch, flush)
            plain = _median_ms(lambda: ppm_pool.pyramid_pool_band_plain(band, v, r0, h), torch)
            every = _median_ms(all_bands, torch, flush)
            whole = _median_ms(lambda: ppm_pool.pyramid_pool(x, valid_hw=v), torch, flush)
            bound, bound_by = band_bound_ms(tuple(band.shape), x.element_size())
            events = _profiled(one, torch, flush, names=(BAND_KERNEL,))
            mine = _matching(events, (BAND_KERNEL,), f"pyramid_pool_band {tuple(band.shape)}")
            ours = [e for e in events if "ppm_" in e.key]
            if mine and (len(ours) != len(mine) or sum(e.count for e in mine) != 10):
                raise RuntimeError(f"pyramid_pool_band: {[(e.key[:60], e.count) for e in ours]} "
                                   "for 10 calls, not one band kernel each")
            out[(bands, dt)] = (warm, cold, plain, bound, bound_by)
            print(f"[time] pyramid_pool_band {tuple(band.shape)} (rows {rows[0]} of "
                  f"{shape}, {bands} bands) {dt}: {warm:.4f} ms warm, {cold:.4f} ms cold; "
                  f"bound {bound:.4f} ms ({bound_by}), share of bound {bound / cold:.3f} cold; "
                  f"plain {plain:.4f} ms; all {bands} bands in turn on one card {every:.4f} ms "
                  f"cold; the pad-aware form on the whole map {whole:.4f} ms cold (median of "
                  f"50); under the profiler (cold) " + (
                      f"one kernel per call, {mine[0].self_device_time_total / 10:.2f} us"
                      if mine else "not measured (no device activity recorded)") +
                  f" (card: {card})", flush=True)
            if compare is not None:
                _turns(lambda lb: lambda: ppm_pool.launch_band(lb, band, v, r0, h),
                       {"this": ppm_pool._lib(), "other": compare}, torch, flush, card,
                       f"pyramid_pool_band {tuple(band.shape)} {dt}")
    return out


def _pass_s(engine, pyrs, labels, torch):
    """Seconds per image of one synchronised pass of ``engine``."""
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for p, lab in zip(pyrs, labels):
        engine.mean_scores(p, lab.shape)
    torch.cuda.synchronize()
    return (time.perf_counter() - tic) / len(pyrs)


def spatial_engines(ckpt, val_dir, odgt, torch, ppm_pool, card):
    """(b): the flagship at full width on cuda:0, each level split in 2
    and 4 bands, against the unsplit bucketed engine over phase 6's images:
    float32 (TF32 off) within SPATIAL_SCORE, bf16 argmax agreement at least
    SPATIAL_AGREE; ``n`` band launches per level; in bf16 one more pass of
    each engine, timed. Returns the launches."""
    from semseg_tpu_torch.checkpoint import resolve_reference_checkpoint
    from semseg_tpu_torch.cli.eval import build_engines

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    launches = 0
    try:
        for dt in ("float32", "bfloat16"):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            cfg = _cfg("DIR", ckpt, "TPU.compute_dtype", dt)
            resolve_reference_checkpoint(cfg, cfg.VAL.checkpoint)
            pyrs, labels = _val_items(cfg, val_dir, odgt)
            levels = sum(len(p) for p in pyrs)
            fetch = None if dt == "float32" else "bfloat16"
            base = build_engines(cfg, 1, device="cuda:0", fetch_dtype=fetch)[0]
            refs = [base.mean_scores(p, lab.shape) for p, lab in zip(pyrs, labels)]
            for n in SPATIAL_BANDS:
                eng = build_engines(cfg, 1, device="cuda:0", fetch_dtype=fetch, spatial=n)[0]

                def run():
                    return [eng.mean_scores(p, lab.shape) for p, lab in zip(pyrs, labels)]

                outs, wall, dense, valid = _run_path(f"spatial engine, {n} bands on cuda:0, "
                                                     f"{dt}", run, ppm_pool, torch,
                                                     band=n * levels)
                launches += n * levels
                err = max((o - r).abs().max().item() for o, r in zip(outs, refs))
                agree = min((o.argmax(0) == r.argmax(0)).float().mean().item()
                            for o, r in zip(outs, refs))
                print(f"[spatial] {n} bands on cuda:0, {dt}: max |dscore| {err:.3e}, argmax "
                      f"agreement (worst image) {agree:.6f} against the unsplit engine over "
                      f"{len(pyrs)} images, {levels} levels; {n * levels} band launches, "
                      f"dense {dense} / valid {valid}; {wall / len(pyrs):.4f} s/image "
                      f"(first pass, card: {card})", flush=True)
                ok = err <= SPATIAL_SCORE if dt == "float32" else agree >= SPATIAL_AGREE
                if not ok or (dense, valid) != (0, 0):
                    raise RuntimeError(f"the spatial engine ({n} bands, {dt}) disagrees with "
                                       f"the unsplit engine: {err:.3e} / {agree:.6f}")
                if dt == "bfloat16":
                    unsplit, split = _pass_s(base, pyrs, labels, torch), _pass_s(
                        eng, pyrs, labels, torch)
                    print(f"[spatial] second pass, bf16: unsplit {unsplit:.4f} s/image, {n} "
                          f"bands on cuda:0 {split:.4f} s/image ({split / unsplit:.2f}x; "
                          f"card: {card})", flush=True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return launches


def spatial_phase(work, torch, ppm_pool, card, ckpt, val_dir, odgt, compare=None):
    """Phase 12: (a)-(c) above. Returns (band launches of the spatial paths,
    the band form's largest sum error, its times)."""
    from semseg_tpu_torch.cli import eval as eval_cli

    start = time.perf_counter()
    err = check_band_kernel(ppm_pool, torch)
    times = time_band_kernel(ppm_pool, torch, card, compare)
    launches = spatial_engines(ckpt, val_dir, odgt, torch, ppm_pool, card)
    cfg = _cfg("DIR", ckpt)
    levels = sum(len(p) for p in _val_items(cfg, val_dir, odgt)[0])
    (miou, acc, _, raw), wall, dense, valid = _run_path(
        "cli.eval --device cuda:0 --spatial 2", lambda: eval_cli.main(
            ["--cfg", CFG, "--device", "cuda:0", "--spatial", "2", "DIR", ckpt,
             "DATASET.root_dataset", val_dir, "DATASET.list_val", odgt]),
        ppm_pool, torch, band=2 * levels)
    launches += 2 * levels
    if (dense, valid) != (0, 0) or not raw["pix_count"] or not 0.0 <= miou <= 1.0:
        raise RuntimeError(f"cli.eval --spatial 2: launches {dense} / {valid}, mIoU {miou}")
    print(f"[spatial] cli.eval --device cuda:0 --spatial 2: mIoU {miou:.4f}, accuracy "
          f"{acc * 100:.2f}% (random weights), {2 * levels} band launches for {levels} levels, "
          f"{wall / len(EVAL_IMAGES):.4f} s/image wall (model build included; card: {card})",
          flush=True)
    print(f"[spatial] phase 12 took {time.perf_counter() - start:.1f} s (card: {card})",
          flush=True)
    return launches, err, times


def spatial_multi_card(ckpt, val_dir, odgt, torch, card, n):
    """The multi-card check's spatial part: the flagship split over cuda:0
    to cuda:n-1 against one card in float32 (TF32 off), within
    SPATIAL_SCORE on three images; then the single-image latency (bf16,
    5 scales) at 1, 2 and 4 cards."""
    import numpy as np

    from semseg_tpu_torch.checkpoint import resolve_reference_checkpoint
    from semseg_tpu_torch.cli.eval import build_engines

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _cfg("DIR", ckpt, "TPU.compute_dtype", "float32")
    resolve_reference_checkpoint(cfg, cfg.VAL.checkpoint)
    pyrs, labels = _val_items(cfg, val_dir, odgt)
    one = build_engines(cfg, 1, device="cuda:0", fetch_dtype=None)[0]
    many = build_engines(cfg, 1, device="cuda", fetch_dtype=None, spatial=n)[0]
    err = max((many.mean_scores(p, lab.shape) - one.mean_scores(p, lab.shape)).abs().max().item()
              for p, lab in list(zip(pyrs, labels))[:3])
    print(f"[multi] spatial engine over {', '.join(map(str, many.spatial_devices))} against "
          f"one card, float32: max |dscore| {err:.3e} (limit {SPATIAL_SCORE})", flush=True)
    if err > SPATIAL_SCORE:
        raise RuntimeError(f"the spatial engine over {n} cards disagrees with one card")
    cfg = _cfg("DIR", ckpt)
    resolve_reference_checkpoint(cfg, cfg.VAL.checkpoint)
    pyrs, labels = _val_items(cfg, val_dir, odgt)
    latency = {}
    for cards in (1, 2, 4):
        if cards > n:
            continue
        eng = build_engines(cfg, 1, device="cuda:0" if cards == 1 else "cuda",
                            fetch_dtype="bfloat16", spatial=cards)[0]
        for p, lab in zip(pyrs, labels):  # warm-up: cuDNN sees every shape
            eng.predict(p, lab.shape)
        times = []
        for p, lab in zip(pyrs, labels):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            eng.predict(p, lab.shape)
            times.append(time.perf_counter() - tic)
        latency[cards] = float(np.median(times))
    print("[multi] single-image latency, flagship bf16, 5 scales, median over "
          f"{len(pyrs)} images: " + ", ".join(f"{k} card(s) {v * 1e3:.1f} ms"
                                              for k, v in latency.items()) +
          f" (card: {card})", flush=True)


# Phase 13: spatial training (``cli.train TPU.spatial``). (a) the pool's band
# backward against its plain version and against the dense backward's rows,
# then timed; (b) one float32 step of the flagship split in 2 and 4 bands on
# cuda:0 against the unsplit step, at batch 2 and at batch 8; (c) bf16: the
# split step's loss falls on a repeated batch, and ms/step split and
# unsplit; (d) ``cli.train --device cuda:0 TPU.spatial 2`` for one epoch.
# (shape, row cuts): the flagship's training conv5 maps, batch 2 at 320x448,
# batch 2 at 448x608 (SPLIT_TRAIN, the map (b)-(c) split) and bench.py's
# batch 8 at 448x608 ((b) at batch 8), each cut as BandPlan cuts its canvas
# in 2 and 4 bands; odd C with bands of one row and bins straddling bands; a
# map whose pixels lie in several bins of a scale per axis, one row a band.
# The second case also runs on gradients one element past a 16-byte
# boundary.
BAND_BACKWARD_CHECKS = [
    ((2, 40, 56, 2048), 2), ((2, 40, 56, 2048), 4), ((2, 56, 76, 2048), 2),
    ((2, 56, 76, 2048), 4), ((8, 56, 76, 2048), 2), ((8, 56, 76, 2048), 4),
    ((2, 13, 17, 250), (0, 1, 2, 6, 7, 13)), ((2, 4, 5, 2048), (0, 1, 2, 3, 4)),
]
# (shape, bands): the band form on the maps (b)-(c) split, at full extents
# (training pools the whole canvas), against its plain version.
SPLIT_BAND_CHECKS = [((2, 56, 76, 2048), 2), ((2, 56, 76, 2048), 4),
                     ((8, 56, 76, 2048), 2), ((8, 56, 76, 2048), 4)]
BAND_BACKWARD_TIMED = [((2, 40, 56, 2048), 2), ((2, 40, 56, 2048), 4), ((8, 56, 76, 2048), 2),
                       ((8, 56, 76, 2048), 4)]
SPLIT_TRAIN = (2, 448, 608)  # the flagship's batch, bench.py's canvas
SPLIT_GRADS = DP_GRADS + ("encoder.conv1.weight",)
# (b)'s gradient limits, {leaf: relative norm error}. At SPLIT_TRAIN phase
# 10 (a)'s GRAD_REL: there the PPM's scale-1 BN normalises over 2 values,
# y = +-1, so the exact gradient of `decoder.ppm.0.1.weight` (the conv
# before it) is 0 and the step computes amplified rounding, which flows
# back into the encoder (measured on an H100: 2.0e-2 / 1.46e-1 for that
# leaf in 2 / 4 bands, the encoder's 2.3e-2 to 9.3e-2). At BENCH_TRAIN that
# BN sees 8 values: the same leaf read 6.5e-3 / 6.8e-3, the encoder's
# 1.5e-2 to 3.1e-2 (f32's own rounding, amplified through ~50 BN layers of
# a random network: phase 8 measured f32 against f64 1.3-2.9%) and the
# last conv, one layer from the loss, 1.0e-4: limits of two to three times
# the readings there, which can see a split's own error that the limits at
# SPLIT_TRAIN cannot.
SPLIT_GRAD_LIMITS = {
    SPLIT_TRAIN: dict.fromkeys(SPLIT_GRADS, GRAD_REL),
    BENCH_TRAIN: {**dict.fromkeys(SPLIT_GRADS, 0.06), "decoder.ppm.0.1.weight": 0.015,
                  "decoder.conv_last.4.weight": 3e-4},
}
SPLIT_TIMED_STEPS = 5


def _cuts(shape, bands, base=8):
    """Row cuts of a map at stride ``base``: explicit, or those of
    ``bands`` BandPlan bands of its canvas (``base`` times its height) cut
    at stride ``base``."""
    from semseg_tpu_torch.parallel.spatial import BandPlan

    if isinstance(bands, tuple):
        return bands
    rows = BandPlan(base * shape[1], bands, base).rows(base)
    return (0,) + tuple(b for _, b in rows)


def check_band_backward_kernel(ppm_pool, torch, checks=BAND_BACKWARD_CHECKS,
                               tag="[spatial-train]", base=8, compare=None) -> float:
    """(a): every band of each case of ``checks`` (its cuts at stride
    ``base``) against the plain version and bit-equal to the dense backward
    kernel's rows, each launch repeated bit for bit; the second case also
    on unaligned gradients. With ``compare``, each band also bit-equal to
    the other build's band backward. Returns the largest absolute
    difference from the plain version."""
    max_err = 0.0
    g = torch.Generator(device="cuda").manual_seed(13)
    lib = ppm_pool._lib()
    cases = [(*c, False) for c in checks] + [(*checks[1], True)]
    for shape, bands, unaligned in cases:
        n, h, w, c = shape
        cuts = _cuts(shape, bands, base)
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            grads = []
            for s in ppm_pool.SCALES:
                flat = torch.randn(n * s * s * c + 1, generator=g, device="cuda").to(dtype)
                grads.append((flat[1:] if unaligned else flat[:-1]).view(n, s, s, c))
            dense = ppm_pool.launch_backward(lib, grads, (h, w))
            err = 0.0
            for a, b in zip(cuts, cuts[1:]):
                out = ppm_pool.launch_band_backward(lib, grads, a, b - a, (h, w))
                if not torch.equal(out, ppm_pool.launch_band_backward(lib, grads, a, b - a,
                                                                      (h, w))):
                    raise RuntimeError(f"pyramid_pool_band_backward {shape} rows [{a}, {b}): "
                                       "two launches differ")
                if not torch.equal(out, dense[:, a:b]):
                    raise RuntimeError(
                        f"pyramid_pool_band_backward {shape} {dt} rows [{a}, {b}): not the "
                        f"dense backward's rows (max |d| "
                        f"{(out.float() - dense[:, a:b].float()).abs().max():.3e})")
                if compare is not None:
                    theirs = ppm_pool.launch_band_backward(compare, grads, a, b - a, (h, w))
                    if not torch.equal(out, theirs):
                        raise RuntimeError(
                            f"pyramid_pool_band_backward {shape} {dt} rows [{a}, {b}): this "
                            f"build differs from the other by "
                            f"{(out.float() - theirs.float()).abs().max():.3e}")
                ref = ppm_pool.pyramid_pool_band_backward_plain(grads, a, b - a, (h, w))
                # As the dense backward against its plain version (phase 8).
                tol = dict(atol=1e-6, rtol=1e-6) if dtype == torch.float32 else \
                    dict(atol=1e-6, rtol=8e-3)
                torch.testing.assert_close(out.float(), ref.float(), **tol)
                err = max(err, (out.float() - ref.float()).abs().max().item())
            max_err = max(max_err, err)
            where = ", unaligned gradients" if unaligned else ""
            other = " and to the other build's" if compare is not None else ""
            print(f"{tag} pyramid_pool_band_backward {shape} {dt} rows {cuts}{where}: "
                  f"ok, each band bit-equal to the dense backward kernel's rows{other} and on "
                  f"repeat; max |d| from the plain version {err:.3e}", flush=True)
    torch.cuda.synchronize()
    return max_err


def band_backward_bound_ms(shape, element_size):
    """Least time of one band backward on an H100 SXM: the band's grad_x
    written once and the 50 bin gradients per channel read once over
    3.35 TB/s, against its adds (50 terms per cell and channel, at most
    121 cells) at 67 TFLOP/s."""
    n, hb, w, c = shape
    moved = (n * hb * w + 50 * n) * c * element_size
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = 2 * 50 * 121 * n * c / 67e12 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def time_band_backward(ppm_pool, torch, card, timed=BAND_BACKWARD_TIMED, base=8,
                       compare=None) -> dict:
    """(a), timed: the first band of each cut of ``timed`` (at stride
    ``base``) warm and L2-cold beside its bound, its plain version, and the
    dense backward on the whole map, cold; one kernel per call under the
    profiler, whose device time is the last number. With ``compare``, the
    other build in turns, its device time too. Returns {(shape, bands,
    dtype): (warm, cold, plain, bound, bound_by, device ms or None)}."""
    flush = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    lib = ppm_pool._lib()
    out = {}
    for shape, bands in timed:
        n, h, w, c = shape
        cuts = _cuts(shape, bands, base)
        r0, hb = cuts[0], cuts[1] - cuts[0]
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            grads = [torch.randn(n, s, s, c, device="cuda").to(dtype) for s in ppm_pool.SCALES]
            run = lambda: ppm_pool.launch_band_backward(lib, grads, r0, hb, (h, w))  # noqa: E731
            warm = _median_ms(run, torch)
            cold = _median_ms(run, torch, flush)
            plain = _median_ms(lambda: ppm_pool.pyramid_pool_band_backward_plain(
                grads, r0, hb, (h, w)), torch)
            dense = _median_ms(lambda: ppm_pool.launch_backward(lib, grads, (h, w)), torch, flush)
            bound, bound_by = band_backward_bound_ms((n, hb, w, c), grads[0].element_size())
            what = f"pyramid_pool_band_backward rows [{r0}, {r0 + hb}) of {shape} {dt}"
            us = _device_us(run, torch, flush, (BACKWARD_KERNEL,), what)
            out[(shape, bands, dt)] = (warm, cold, plain, bound, bound_by,
                                       None if us is None else us / 1e3)
            share = "" if us is None else f", {bound * 1e3 / us:.3f} of the device time"
            print(f"[time] pyramid_pool_band_backward rows [{r0}, {r0 + hb}) of {shape} "
                  f"({len(cuts) - 1} bands) {dt}: kernel {warm:.4f} ms warm, {cold:.4f} ms cold; "
                  f"bound {bound:.4f} ms ({bound_by}), share of bound {bound / cold:.3f} cold, "
                  f"{bound / warm:.3f} warm{share}; kernel under the profiler (cold) {_us(us)}; "
                  f"plain {plain:.4f} ms; the dense backward on the whole map {dense:.4f} ms "
                  f"cold (median of 50; card: {card})", flush=True)
            if compare is not None:
                _turns(lambda lb: lambda: ppm_pool.launch_band_backward(lb, grads, r0, hb, (h, w)),
                       {"this": lib, "other": compare}, torch, flush, card, what,
                       (BACKWARD_KERNEL,))
    return out


def _split_batch(torch, seed, n, h, w, device, label_stride=8):
    import numpy as np

    rng = np.random.RandomState(seed)
    host = {"img_data": rng.randn(n, h, w, 3).astype(np.float32),
            "seg_label": rng.randint(-1, 150, (n, h // label_stride, w // label_stride))
            .astype(np.int32)}
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def _split_step(torch, ppm_pool, name, cfg, batch, spatial, device, keys=SPLIT_GRADS,
                pooled=True):
    """One step from the seeded weights on ``batch``, dropout from step 0's
    generator; the pool's launches counted (``pooled``: the model has a
    pyramid pool). Returns (loss, acc, the gradients of ``keys`` and every
    BN buffer on the CPU)."""
    from semseg_tpu_torch.parallel import dropout_generator, train_step

    state = _train_model(torch, cfg, device, spatial=spatial)
    bands = len(spatial) if spatial and pooled else 0

    def step():
        m = train_step(state, batch, dropout_generator(0, 0))
        return float(m["loss"]), float(m["acc"])

    dense_want = 0 if spatial or not pooled else 1
    (loss, acc), _, dense, valid = _run_path(name, step, ppm_pool, torch, backward=dense_want,
                                             band=bands, band_backward=bands)
    if (dense, valid) != (dense_want, 0):
        raise RuntimeError(f"{name}: pool launches dense {dense} / valid {valid}")
    params = dict(state.model.named_parameters())
    grads = {k: params[k].grad.to("cpu", copy=True) for k in keys}
    stats = {k: v.to("cpu", copy=True) for k, v in state.model.state_dict().items()
             if "running" in k}
    del state
    torch.cuda.empty_cache()
    return loss, acc, grads, stats


def split_step_against_unsplit(torch, ppm_pool, card, devices, tag, shape=SPLIT_TRAIN,
                               path=CFG, limits=None):
    """(b), 14 (c) and the multi-card check: one float32 step (TF32 off,
    deterministic algorithms) of ``path``'s model (the flagship) at full
    width on a batch of ``shape`` (N, H, W), its images split over each
    device list of ``devices``, against the unsplit step on cuda:0 from the
    same weights, batch and dropout generator; each gradient of ``limits``
    (SPLIT_GRAD_LIMITS[shape]) within its limit in relative norm. Returns
    the band launches."""
    limits = SPLIT_GRAD_LIMITS[shape] if limits is None else limits
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _cfg("TPU.compute_dtype", "float32", path=path)
    pooled = cfg.MODEL.arch_decoder in POOLED_DECODERS
    dev0 = "cuda:0" if CARD == "cuda" else CARD
    batch = _split_batch(torch, 15, *shape, dev0, cfg.DATASET.segm_downsampling_rate)
    launches = 0
    try:
        with _deterministic(torch):
            ref = _split_step(torch, ppm_pool, f"{tag} unsplit step", cfg, batch, None, dev0,
                              tuple(limits), pooled)
            for spatial in devices:
                got = _split_step(torch, ppm_pool, f"{tag} split step over {spatial}", cfg,
                                  batch, spatial, dev0, tuple(limits), pooled)
                launches += len(spatial) if pooled else 0
                loss_rel = abs(got[0] - ref[0]) / abs(ref[0])
                grads = {k: float((got[2][k] - v).norm() / v.norm()) for k, v in ref[2].items()}
                stat_rel, stat_key, iters_equal = 0.0, "", True
                for k, b in ref[3].items():
                    a = got[3][k]
                    if k.endswith("_running_iter"):
                        iters_equal = iters_equal and torch.equal(a, b)
                        continue
                    rel = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                    stat_rel, stat_key = max((stat_rel, stat_key), (rel, k))
                print(f"{tag} {len(spatial)} bands on {sorted(set(map(str, spatial)))}, f32, "
                      f"TF32 off, deterministic, batch {shape[0]} at {shape[1]}x{shape[2]}, "
                      f"dropout on, against the unsplit step on {dev0}: loss {got[0]:.6f} vs "
                      f"{ref[0]:.6f}, relative {loss_rel:.2e} (limit {LOSS_REL}); accuracy "
                      f"{got[1]:.6f} vs {ref[1]:.6f} (limit {DP_ACC}); gradients, relative "
                      f"norm error: "
                      + ", ".join(f"{k} {v:.3e} (limit {limits[k]})" for k, v in grads.items())
                      + f"; BN statistics max |d| / max {stat_rel:.2e} ({stat_key}; limit "
                      f"{STAT_REL}); iter equal {iters_equal}; "
                      + (f"{len(spatial)} band forward and {len(spatial)} band backward "
                         "launches, no dense ones" if pooled else "no pool launches")
                      + f" (card: {card})", flush=True)
                if not (loss_rel < LOSS_REL and abs(got[1] - ref[1]) < DP_ACC
                        and stat_rel < STAT_REL and iters_equal
                        and all(v < limits[k] for k, v in grads.items())):
                    raise RuntimeError(f"the split step over {spatial} disagrees with the "
                                       "unsplit step")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return launches


def split_loss_falls_and_timing(torch, ppm_pool, root, odgt, card):
    """(c): bf16, the split step (2 bands on cuda:0) on one repeated batch
    of phase 8's set for 5 steps under deterministic algorithms: the loss
    falls. Then ms/step (default algorithms) unsplit and split in 2 and 4
    bands on cuda:0 at SPLIT_TRAIN, median of SPLIT_TIMED_STEPS after one
    warm-up step. Returns (the band launches, the times)."""
    from semseg_tpu_torch.data import TrainDataset
    from semseg_tpu_torch.parallel import dropout_generator, train_step

    dev0 = "cuda:0" if CARD == "cuda" else CARD
    cfg = _cfg(*_train_cfg_opts(root, odgt))
    host = TrainDataset(root, odgt, cfg.DATASET, batch_per_gpu=2, seed=1,
                        bucket_step=cfg.TPU.bucket_step, raw_transport=True).next_batch()
    batch = {k: torch.from_numpy(v).to(dev0) for k, v in host.items()}
    state = _train_model(torch, cfg, dev0, spatial=[dev0] * 2)

    def five():
        with _deterministic(torch):
            return [float(train_step(state, batch, dropout_generator(0, i))["loss"])
                    for i in range(5)]

    losses, _, dense, valid = _run_path("split step, 2 bands, 5 steps on one batch", five,
                                        ppm_pool, torch, band=10, band_backward=10)
    print(f"[spatial-train] (c) one repeated batch {tuple(host['img_data'].shape)}, 2 bands on "
          f"{dev0}, bf16, 5 steps under deterministic algorithms: losses "
          f"{[round(x, 4) for x in losses]} (card: {card})", flush=True)
    if not losses[-1] < losses[0] or (dense, valid) != (0, 0):
        raise RuntimeError(f"the split step's loss did not fall: {losses} (dense {dense})")
    del state
    more, times = split_timing(torch, ppm_pool, [None, [dev0] * 2, [dev0] * 4], card,
                               "[spatial-train] (c)")
    return 10 + more, times


def split_timing(torch, ppm_pool, lists, card, tag, path=CFG, steps=1 + SPLIT_TIMED_STEPS):
    """ms/step and peak memory of the bf16 step of ``path``'s model (the
    flagship) at SPLIT_TRAIN (default algorithms), unsplit (``None``) and
    split over each device list of ``lists``: median of ``steps`` - 1
    after a warm-up step. Returns (the band launches, {bands: (ms, GiB)})."""
    import numpy as np

    from semseg_tpu_torch.parallel import dropout_generator, train_step

    dev0 = "cuda:0" if CARD == "cuda" else CARD
    cfg = _cfg(path=path)
    pooled = cfg.MODEL.arch_decoder in POOLED_DECODERS
    batch = _split_batch(torch, 16, *SPLIT_TRAIN, dev0, cfg.DATASET.segm_downsampling_rate)
    launches, times = 0, {}
    for spatial in lists:
        bands = len(spatial) if spatial and pooled else 0
        state = _train_model(torch, cfg, dev0, spatial=spatial)

        def run():
            out = []
            for i in range(steps):
                torch.cuda.synchronize()
                tic = time.perf_counter()
                float(train_step(state, batch, dropout_generator(0, i))["loss"])
                out.append(time.perf_counter() - tic)
            return out

        name = (f"over {sorted(set(map(str, spatial)))} in {len(spatial)} bands" if spatial
                else "unsplit")
        seconds, _, _, _ = _run_path(f"{tag} {name}, {steps} steps", run, ppm_pool, torch,
                                     backward=0 if spatial or not pooled else steps,
                                     band=bands * steps, band_backward=bands * steps)
        launches += bands * steps
        times[name] = (float(np.median(seconds[1:])) * 1e3,
                       torch.cuda.max_memory_allocated() / 2**30)
        del state
        torch.cuda.empty_cache()
    print(f"{tag} ms/step, {cfg.MODEL.arch_encoder} + {cfg.MODEL.arch_decoder} bf16, batch "
          f"{SPLIT_TRAIN[0]} at {SPLIT_TRAIN[1]}x{SPLIT_TRAIN[2]}, median of {steps - 1} after "
          "a warm-up "
          f"(peak device memory of the first card): " + "; ".join(
              f"{k} {t:.1f} ms, {m:.2f} GiB" for k, (t, m) in times.items())
          + f" (card: {card})", flush=True)
    return launches, times


def split_train_cli(work, torch, ppm_pool, root, odgt, card, remat=False):
    """(d): ``cli.train --device cuda:0 ... TPU.spatial 2``, one epoch of
    phase 8's data and settings, writes its checkpoint pair; with ``remat``
    (phase 15 (d)) ``TPU.remat True`` too, each of the flagship's 16 blocks
    recomputed once a step. Returns the band launches."""
    import numpy as np

    from semseg_tpu_torch.cli import train as train_cli
    from semseg_tpu_torch.models import resnet

    name = "TPU.spatial 2" + (" TPU.remat True" if remat else "")
    out = os.path.join(work, "spatial_remat_train" if remat else "spatial_train")
    dev0 = "cuda:0" if CARD == "cuda" else CARD
    want = 2 * TRAIN_ITERS
    before = resnet.RECOMPUTES
    (state, history), wall, dense, valid = _run_path(
        f"cli.train --device cuda:0 {name}", lambda: train_cli.main(
            ["--cfg", CFG, "--device", dev0, "--devices", "1", "DIR", out,
             *_train_cfg_opts(root, odgt), "TRAIN.num_epoch", "1", *name.split()]),
        ppm_pool, torch, band=want, band_backward=want)
    recomputes = resnet.RECOMPUTES - before
    losses = history["train"]["loss"]
    pair = [os.path.join(out, f"{p}_epoch_1.pth") for p in ("encoder", "decoder")]
    if (dense, valid) != (0, 0) or not all(np.isfinite(losses)) or not all(
            os.path.exists(p) for p in pair) or state.step != TRAIN_ITERS \
            or recomputes != (FLAGSHIP_BLOCKS * TRAIN_ITERS if remat else 0):
        raise RuntimeError(f"cli.train {name}: launches {dense}/{valid}, losses {losses}, "
                           f"files {os.listdir(out)}, {recomputes} recomputes")
    print(f"[spatial-{'remat' if remat else 'train'}] (d) cli.train --device {dev0} {name}: "
          f"{TRAIN_ITERS} steps at batch 2, bf16, full width, losses at the display steps "
          f"{[round(x, 4) for x in losses]}; {want} band forward and {want} band backward "
          f"launches, no dense ones; {recomputes} blocks recomputed; wrote the epoch_1 pair; "
          f"{wall:.1f} s wall (model build and loader start included; card: {card})",
          flush=True)
    return want


def spatial_train_phase(work, torch, ppm_pool, card, root, odgt, compare=None):
    """Phase 13: (a)-(d) above (with ``compare``, (a) also against the
    other build). Returns (the band forward and band backward launches of
    the training paths, the band backward's largest error from its plain
    version, its times, ms/step split and unsplit)."""
    start = time.perf_counter()
    band_err = check_band_kernel(ppm_pool, torch, [
        (shape, [list(shape[1:3])] * shape[0], _cuts(shape, bands))
        for shape, bands in SPLIT_BAND_CHECKS], "[spatial-train]")
    err = check_band_backward_kernel(ppm_pool, torch, compare=compare)
    times = time_band_backward(ppm_pool, torch, card, compare=compare)
    dev0 = "cuda:0" if CARD == "cuda" else CARD
    launches = sum(split_step_against_unsplit(torch, ppm_pool, card, [[dev0] * 2, [dev0] * 4],
                                              "[spatial-train] (b)", shape)
                   for shape in SPLIT_GRAD_LIMITS)
    more, step_ms = split_loss_falls_and_timing(torch, ppm_pool, root, odgt, card)
    launches += more + split_train_cli(work, torch, ppm_pool, root, odgt, card)
    print(f"[spatial-train] phase 13 took {time.perf_counter() - start:.1f} s (card: {card})",
          flush=True)
    return launches, err, times, step_ms, band_err


def zoo_spatial_multi_card(zoo_ckpts, val_dir, odgt, torch, card, n):
    """The multi-card check's part of phase 14: UPerNet's engine split over
    cuda:0 to cuda:n-1 against one card in float32 (TF32 off), within
    ZOO_UPERNET_SCORE on phase 14 (b)'s images."""
    from semseg_tpu_torch.checkpoint import resolve_reference_checkpoint
    from semseg_tpu_torch.cli.eval import build_engines

    name = ZOO_SPATIAL_CONFIGS[0]
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _cfg("DIR", zoo_ckpts[name], "TPU.compute_dtype", "float32",
               path=os.path.join(HERE, "config", name))
    resolve_reference_checkpoint(cfg, cfg.VAL.checkpoint)
    pyrs, labels = _val_items(cfg, val_dir, odgt)
    one = build_engines(cfg, 1, device="cuda:0", fetch_dtype=None)[0]
    many = build_engines(cfg, 1, device="cuda", fetch_dtype=None, spatial=n)[0]
    err = max((many.mean_scores(p, lab.shape) - one.mean_scores(p, lab.shape)).abs().max().item()
              for p, lab in list(zip(pyrs, labels))[:ZOO_SPATIAL_IMAGES])
    print(f"[multi] {name} spatial engine over {', '.join(map(str, many.spatial_devices))} "
          f"against one card, float32: max |dscore| {err:.3e} (limit {ZOO_UPERNET_SCORE}; "
          f"card: {card})", flush=True)
    if err > ZOO_UPERNET_SCORE:
        raise RuntimeError(f"{name}'s spatial engine over {n} cards disagrees with one card")


def spatial_train_multi_card(work, torch, ppm_pool, card, root, odgt, n):
    """The multi-card check's training part: the split step with its bands
    on distinct cards against one card (as (b)), then ``cli.train --device
    cuda TPU.spatial 2`` over the cards (n / 2 data groups, one rank each)
    for one epoch."""
    import numpy as np

    from semseg_tpu_torch.cli import train as train_cli

    lists = [[f"cuda:{j}" for j in range(b)] for b in (2, 4) if b <= n]
    for shape in SPLIT_GRAD_LIMITS:
        split_step_against_unsplit(torch, ppm_pool, card, lists, "[multi] spatial step,", shape)
    split_timing(torch, ppm_pool, [None] + lists, card, "[multi] spatial step,")
    out = os.path.join(work, "multi_spatial_train")
    tic = time.perf_counter()
    result = train_cli.main(["--cfg", CFG, "--devices", str(n // 2), "DIR", out,
                             *_train_cfg_opts(root, odgt),
                             "TRAIN.num_epoch", "1", "TRAIN.disp_iter", "1", "TRAIN.workers",
                             "1", "TPU.spatial", "2"])
    wall = time.perf_counter() - tic
    with open(os.path.join(out, "history_epoch_1.json")) as f:
        losses = json.load(f)["train"]["loss"]
    if len(losses) != TRAIN_ITERS or not np.all(np.isfinite(losses)) \
            or not os.path.exists(os.path.join(out, "encoder_epoch_1.pth")):
        raise RuntimeError(f"cli.train TPU.spatial 2 over {n} cards: result {result}, "
                           f"losses {losses}")
    print(f"[multi] cli.train TPU.spatial 2 over {n} cards ({n // 2} data group(s) of 2 "
          f"cards): {TRAIN_ITERS} steps at batch 2 per group, bf16, full width; per-step "
          f"global losses {losses}; {wall:.1f} s wall (spawn, model builds and the "
          f"checkpoint included; card: {card})", flush=True)


# Phase 14: the spatial zoo (``cli.eval --spatial``, ``cli.train TPU.spatial``
# for UPerNet on the non-dilated ResNet-50 and for HRNetV2, whose band plans
# cut the canvas at stride 32). (a) the pool's band form and band backward on
# UPerNet's conv5 maps; (b) each config split in 2 and 4 bands on cuda:0
# against its unsplit engine; (c) one float32 step split in 2 and 4 bands
# against the unsplit step at batch 8; (d) bf16 ms/step and peak memory
# unsplit and split, and ``cli.eval --spatial 2`` / ``cli.train ...
# TPU.spatial 2`` of both configs. The configs' weights are the zoo phase's
# seeded .pth pairs.
ZOO_SPATIAL_CONFIGS = ["ade20k-resnet50-upernet.yaml", "ade20k-hrnetv2.yaml"]
# (a) eval: conv5 of a 600x800 canvas (stride 32: 19 x 25) in 2 and 4
# bands of its BandPlan, at full extents and at a 480x600 image's; the band
# form on the training maps (bench.py's 448x608 canvas, batch 2 and 8) at
# full extents; the band backward there, and in bands of 1 to 3 rows.
ZOO_BAND_SHAPE = (1, 19, 25, 2048)
ZOO_BAND_CHECKS = [(ZOO_BAND_SHAPE, [[19, 25]], 2), (ZOO_BAND_SHAPE, [[19, 25]], 4),
                   (ZOO_BAND_SHAPE, [[15, 19]], 4), ((2, 14, 19, 2048), [[14, 19]] * 2, 2),
                   ((2, 14, 19, 2048), [[14, 19]] * 2, 4), ((8, 14, 19, 2048), [[14, 19]] * 8, 4)]
ZOO_BAND_BACKWARD_CHECKS = [((2, 14, 19, 2048), 2), ((2, 14, 19, 2048), 4),
                            ((2, 14, 19, 2048), (0, 1, 3, 6, 9, 12, 14)),
                            ((8, 14, 19, 2048), 2), ((8, 14, 19, 2048), 4)]
ZOO_BAND_BACKWARD_TIMED = [((2, 14, 19, 2048), 2), ((8, 14, 19, 2048), 2)]
# (b): the first images of phase 6's val set, each config's own scales.
# HRNetV2 (logits ~1e8, one-hot probabilities) within SPATIAL_SCORE; UPerNet
# within ZOO_UPERNET_SCORE, tests/test_torch_zoo.py's bar for its
# random-weight logits (~1e3), where the bands' other summation orders move
# a near-one-hot softmax more than the flagship's.
ZOO_SPATIAL_IMAGES = 2
ZOO_UPERNET_SCORE = 1e-3
# (c): the limits of PR 11's batch-8 step (SPLIT_GRAD_LIMITS[BENCH_TRAIN]):
# the stem's conv and the deep layers 0.06, the last conv, one layer from
# the loss, 3e-4. UPerNet's scale-1 ppm_conv (its BN normalises a map of N
# distinct values, as the flagship's ppm.0.1 does at 0.015) read 1.6e-2 in
# a float32 rehearsal on the CPU (batch 8 at 128x64, 2 bands): 0.05, three
# times that.
ZOO_SPLIT_GRAD_LIMITS = {
    "ade20k-resnet50-upernet.yaml": {
        "encoder.conv1.weight": 0.06, "decoder.ppm_conv.0.0.weight": 0.05,
        "decoder.fpn_in.0.0.weight": 0.06, "decoder.conv_last.1.weight": 3e-4},
    "ade20k-hrnetv2.yaml": {
        "encoder.conv1.weight": 0.06, "encoder.stage4.0.fuse_layers.0.1.0.weight": 0.06,
        "decoder.conv_last.weight": 3e-4},
}
ZOO_TIMED_STEPS = 2


def zoo_band_kernels(ppm_pool, torch, card, compare=None):
    """(a): the band form and the band backward on UPerNet's stride-32 conv5
    maps against their plain versions, bit-equal on repeat, each backward
    band bit-equal to the dense backward's rows (and with ``compare`` to the
    other build's band backward, timed against it in turns); timed L2-cold
    beside their bounds. Returns (the band form's largest error, the band
    backward's, the band form's times, the band backward's)."""
    band_err = check_band_kernel(ppm_pool, torch, [
        (shape, extents, _cuts(shape, bands, 32)) for shape, extents, bands in ZOO_BAND_CHECKS],
        "[spatial-zoo]")
    backward_err = check_band_backward_kernel(ppm_pool, torch, ZOO_BAND_BACKWARD_CHECKS,
                                              "[spatial-zoo]", base=32, compare=compare)
    band_times = time_band_kernel(ppm_pool, torch, card, shape=ZOO_BAND_SHAPE, base=32)
    backward_times = time_band_backward(ppm_pool, torch, card, ZOO_BAND_BACKWARD_TIMED, base=32,
                                        compare=compare)
    return band_err, backward_err, band_times, backward_times


def _zoo_band_launches(cfg, pyrs, n):
    """Band launches of a split engine over ``pyrs`` in ``n`` bands: one
    per non-empty band of each level's bucket canvas (a plan cut at the
    encoder's coarsest stride), 0 for a decoder without a pyramid pool."""
    from semseg_tpu_torch.data.dataset import _effective_lattice
    from semseg_tpu_torch.parallel.spatial import BandPlan

    if cfg.MODEL.arch_decoder not in POOLED_DECODERS:
        return 0
    step = _effective_lattice(cfg.TPU.eval_bucket_step, cfg.DATASET.padding_constant)
    base = 8 if cfg.MODEL.arch_encoder.endswith("dilated") else 32
    return sum(BandPlan(-(-lvl.shape[1] // step) * step, n, base).count
               for p in pyrs for lvl in p)


def _level_logits(base, eng, level, torch):
    """One uint8 level's f32 logits through the unsplit engine ``base`` and
    the split engine ``eng``: the largest relative difference."""
    import numpy as np

    h, w = level.shape[1:3]
    ph, pw = base._bucket_key(h, w)
    img = torch.from_numpy(np.pad(level, ((0, 0), (0, ph - h), (0, pw - w), (0, 0)))).to(
        base.device)
    hw = torch.tensor([[h, w]], dtype=torch.int32, device=base.device)
    with torch.inference_mode():
        a = base._logits_raw_fn(img, hw, to_fetch=False).float()
        b = eng._logits_spatial(img, hw).float()
    return ((b - a).abs().max() / a.abs().max()).item()


def _latency_s(engine, pyrs, labels, torch):
    """Median single-image latency (``predict``) of an engine that has run
    these images once (cuDNN has seen every level's shapes)."""
    import numpy as np

    times = []
    for p, lab in zip(pyrs, labels):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        engine.predict(p, lab.shape)
        times.append(time.perf_counter() - tic)
    return float(np.median(times))


def zoo_spatial_engines(zoo_ckpts, val_dir, odgt, torch, ppm_pool, card):
    """(b): each config of ZOO_SPATIAL_CONFIGS at full width on cuda:0, each
    level split in 2 and 4 bands, against the unsplit bucketed engine over
    the first ZOO_SPATIAL_IMAGES of phase 6's images: float32 (TF32 off)
    within its score limit, with the logits' largest relative difference
    on the first level printed; bf16 argmax agreement at least
    SPATIAL_AGREE; the band launches counted (UPerNet's PPM: one per band
    and non-empty band of a level; HRNetV2 + C1 pools nothing); single-image
    latency in bf16,
    unsplit and split. Returns the band launches."""
    from semseg_tpu_torch.checkpoint import resolve_reference_checkpoint
    from semseg_tpu_torch.cli.eval import build_engines

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    launches = 0
    try:
        for name in ZOO_SPATIAL_CONFIGS:
            path = os.path.join(HERE, "config", name)
            for dt in ("float32", "bfloat16"):
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
                cfg = _cfg("DIR", zoo_ckpts[name], "TPU.compute_dtype", dt, path=path)
                resolve_reference_checkpoint(cfg, cfg.VAL.checkpoint)
                limit = ZOO_UPERNET_SCORE if cfg.MODEL.arch_decoder.startswith("upernet") \
                    else SPATIAL_SCORE
                tag = f"{cfg.MODEL.arch_encoder} + {cfg.MODEL.arch_decoder}"
                pyrs, labels = _val_items(cfg, val_dir, odgt)
                pyrs, labels = pyrs[:ZOO_SPATIAL_IMAGES], labels[:ZOO_SPATIAL_IMAGES]
                levels = sum(len(p) for p in pyrs)
                fetch = None if dt == "float32" else "bfloat16"
                base = build_engines(cfg, 1, device="cuda:0", fetch_dtype=fetch)[0]
                refs = [base.mean_scores(p, lab.shape) for p, lab in zip(pyrs, labels)]
                latency = {}
                for n in SPATIAL_BANDS:
                    eng = build_engines(cfg, 1, device="cuda:0", fetch_dtype=fetch,
                                        spatial=n)[0]

                    def run():
                        return [eng.mean_scores(p, lab.shape) for p, lab in zip(pyrs, labels)]

                    want = _zoo_band_launches(cfg, pyrs, n)
                    outs, wall, dense, valid = _run_path(
                        f"spatial zoo {tag}, {n} bands on cuda:0, {dt}", run, ppm_pool, torch,
                        band=want)
                    launches += want
                    err = max((o - r).abs().max().item() for o, r in zip(outs, refs))
                    agree = min((o.argmax(0) == r.argmax(0)).float().mean().item()
                                for o, r in zip(outs, refs))
                    rel = _level_logits(base, eng, pyrs[0][0], torch)
                    print(f"[spatial-zoo] {tag}, {n} bands on cuda:0, {dt}: max |dscore| "
                          f"{err:.3e} (limit {limit if dt == 'float32' else '-'}), argmax "
                          f"agreement (worst image) {agree:.6f} against the unsplit engine over "
                          f"{len(pyrs)} images, {levels} levels; logits of the first level: "
                          f"max |d| / max {rel:.3e}; {want} band launches, dense {dense} / "
                          f"valid {valid}; {wall / len(pyrs):.4f} s/image (first pass, card: "
                          f"{card})", flush=True)
                    ok = err <= limit if dt == "float32" else agree >= SPATIAL_AGREE
                    if not ok or (dense, valid) != (0, 0):
                        raise RuntimeError(f"the spatial engine of {name} ({n} bands, {dt}) "
                                           f"disagrees with the unsplit engine: {err:.3e} / "
                                           f"{agree:.6f}")
                    if dt == "bfloat16":
                        latency[n] = _latency_s(eng, pyrs, labels, torch)
                    del eng
                if dt == "bfloat16":
                    latency[1] = _latency_s(base, pyrs, labels, torch)
                    print(f"[spatial-zoo] {tag} single-image latency, bf16, "
                          f"{len(cfg.DATASET.imgSizes)} scales, median of {len(pyrs)} images "
                          f"after the checked pass: unsplit {latency[1] * 1e3:.1f} ms, "
                          + ", ".join(
                              f"{n} bands on cuda:0 {latency[n] * 1e3:.1f} ms "
                              f"({latency[n] / latency[1]:.2f}x)" for n in SPATIAL_BANDS)
                          + f" (card: {card})", flush=True)
                del base
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return launches


def zoo_spatial_cli(work, zoo_ckpts, root, odgt, torch, ppm_pool, card):
    """(d), the CLIs: ``cli.eval --device cuda:0 --spatial 2`` over one
    image and ``cli.train --device cuda:0 ... TPU.spatial 2`` for one epoch
    of phase 8's data, for each config. Returns (band launches, band
    backward launches)."""
    import numpy as np

    from semseg_tpu_torch.cli import eval as eval_cli, train as train_cli

    val_dir = os.path.join(work, "zoo_spatial_val")
    val_odgt = _write_val_set(val_dir, ZOO_IMAGES[:1], seed=14)
    band = backward = 0
    for name in ZOO_SPATIAL_CONFIGS:
        path = os.path.join(HERE, "config", name)
        cfg = _cfg(path=path)
        pooled = cfg.MODEL.arch_decoder in POOLED_DECODERS
        tag = f"{cfg.MODEL.arch_encoder} + {cfg.MODEL.arch_decoder}"
        levels = len(cfg.DATASET.imgSizes)
        want = _zoo_band_launches(cfg, _val_items(cfg, val_dir, val_odgt)[0], 2)
        (miou, acc, _, raw), wall, dense, valid = _run_path(
            f"spatial zoo {tag}: cli.eval --device cuda:0 --spatial 2", lambda: eval_cli.main(
                ["--cfg", path, "--device", "cuda:0", "--spatial", "2", "DIR",
                 zoo_ckpts[name], "DATASET.root_dataset", val_dir, "DATASET.list_val",
                 val_odgt]), ppm_pool, torch, band=want)
        if (dense, valid) != (0, 0) or not raw["pix_count"] or not 0.0 <= miou <= 1.0:
            raise RuntimeError(f"{name} cli.eval --spatial 2: launches {dense} / {valid}, "
                               f"mIoU {miou}")
        band += want
        out = os.path.join(work, "zoo_spatial_train", name[:-5])
        steps = 2 * TRAIN_ITERS if pooled else 0
        (state, history), train_wall, dense, valid = _run_path(
            f"spatial zoo {tag}: cli.train --device cuda:0 TPU.spatial 2",
            lambda: train_cli.main(["--cfg", path, "--device", "cuda:0", "--devices", "1",
                                    "DIR", out, *_train_cfg_opts(root, odgt),
                                    "TRAIN.num_epoch", "1", "TPU.spatial", "2"]),
            ppm_pool, torch, band=steps, band_backward=steps)
        losses = history["train"]["loss"]
        pair = [os.path.join(out, f"{p}_epoch_1.pth") for p in ("encoder", "decoder")]
        if (dense, valid) != (0, 0) or not all(np.isfinite(losses)) or not all(
                os.path.exists(p) for p in pair) or state.step != TRAIN_ITERS:
            raise RuntimeError(f"{name} cli.train TPU.spatial 2: launches {dense}/{valid}, "
                               f"losses {losses}, files {os.listdir(out)}")
        band += steps
        backward += steps
        print(f"[spatial-zoo] {tag}: cli.eval --device cuda:0 --spatial 2 over one image, "
              f"{levels} scales: mIoU {miou:.4f} (random weights), {want} band launches, "
              f"{wall:.1f} s wall; cli.train --device cuda:0 TPU.spatial 2: {TRAIN_ITERS} "
              f"steps at batch 2, bf16, losses at the display steps "
              f"{[round(x, 4) for x in losses]}, {steps} band forward and backward launches, "
              f"wrote the epoch_1 pair, {train_wall:.1f} s wall (model builds and loader "
              f"start included; card: {card})", flush=True)
    return band, backward


def spatial_zoo_phase(work, torch, ppm_pool, card, zoo_ckpts, val_dir, odgt, root, train_odgt,
                      compare=None):
    """Phase 14: (a)-(d) above (with ``compare``, (a)'s band backward also
    against the other build). Returns (band launches, band backward
    launches, the band form's largest error, the band backward's, their
    times)."""
    start = time.perf_counter()
    band_err, backward_err, band_times, backward_times = zoo_band_kernels(ppm_pool, torch,
                                                                          card, compare)
    band = zoo_spatial_engines(zoo_ckpts, val_dir, odgt, torch, ppm_pool, card)
    backward = 0
    dev0 = "cuda:0" if CARD == "cuda" else CARD
    for name in ZOO_SPATIAL_CONFIGS:
        path = os.path.join(HERE, "config", name)
        more = split_step_against_unsplit(torch, ppm_pool, card, [[dev0] * 2, [dev0] * 4],
                                          "[spatial-zoo] (c)", BENCH_TRAIN, path,
                                          ZOO_SPLIT_GRAD_LIMITS[name])
        band, backward = band + more, backward + more
        more, _ = split_timing(torch, ppm_pool, [None, [dev0] * 2, [dev0] * 4], card,
                               "[spatial-zoo] (d)", path, 1 + ZOO_TIMED_STEPS)
        band, backward = band + more, backward + more
    more, more_backward = zoo_spatial_cli(work, zoo_ckpts, root, train_odgt, torch, ppm_pool,
                                          card)
    band, backward = band + more, backward + more_backward
    print(f"[spatial-zoo] phase 14 took {time.perf_counter() - start:.1f} s; {band} band and "
          f"{backward} band backward launches (card: {card})", flush=True)
    return band, backward, band_err, backward_err, band_times, backward_times


# Phase 15: ``TPU.remat`` under ``TPU.spatial``, each banded ResNet block one
# checkpoint over all its bands. (a) the flagship in float32 (TF32 off,
# deterministic algorithms) at SPLIT_TRAIN split in 2 and 4 bands on cuda:0:
# two steps with remat against two without from the same weights, batches
# and dropout generators: losses, accuracies, every parameter, gradient and
# BN buffer bit-equal, each of its 16 blocks recomputed once a step, the
# band forward and backward launched as without remat; (b) the same for
# UPerNet (stride 32) in 2 bands, one step; (c) bf16 (default algorithms)
# ms/step, peak memory and the memory allocated between steps, remat on
# against off, at SPLIT_TRAIN in 2 and 4 bands and at BENCH_TRAIN in 2: remat
# must lower the peak; (d) ``cli.train --device cuda:0 TPU.spatial 2 TPU.remat
# True`` for one epoch of phase 8's data. With several cards the multi-card
# check adds (a) over cuda:0-1 and cuda:0-3 with one backward thread
# (bit-equal), two NCCL ranks of 2 cards each (remat on against off: as many
# all-reduces a step; bit-equal states with one backward thread), ``cli.train
# --devices N/2 TPU.spatial 2 TPU.remat True`` (the ranks and the CLI killed
# after SPATIAL_REMAT_TIMEOUT), and, with the default multithreaded backward,
# one f32 step at BENCH_TRAIN over the cards, remat on against off: the
# forward (loss, accuracy, BN buffers) bit-equal and every gradient within
# its SPATIAL_REMAT_THREAD_LIMITS.
FLAGSHIP_BLOCKS = 16  # ResNet-50's 3 + 4 + 6 + 3
SPATIAL_REMAT_COST = [(SPLIT_TRAIN, 2), (SPLIT_TRAIN, 4), (BENCH_TRAIN, 2)]
SPATIAL_REMAT_TIMED = 3  # timed steps after a warm-up step, each setting
SPATIAL_REMAT_TIMEOUT = 600  # seconds for the ranks and for the CLI over cards
# Over cards with multithreaded backward, {leaf: relative norm error} of a
# gradient with remat against the split step without it. There a tensor
# that takes gradients from several cards sums them in the order they
# arrive, so the two differ by f32 rounding, amplified back through the
# network as between the split and the unsplit step: (b)'s limits at
# BENCH_TRAIN (SPLIT_GRAD_LIMITS), 0.06 for every other leaf. A recompute
# that saved wrong tensors moves a gradient by its own magnitude.
SPATIAL_REMAT_THREAD_LIMITS = SPLIT_GRAD_LIMITS[BENCH_TRAIN]
SPATIAL_REMAT_THREAD_REL = 0.06


def _remat_steps(torch, ppm_pool, tag, cfg, batches, spatial, device, pooled):
    """A fresh train state of ``cfg`` from the seeded weights, one step on
    each of ``batches`` (step i's dropout generator) split over ``spatial``,
    each band's pool forward and backward launched once a step. Returns
    (the steps' (loss, accuracy), the blocks recomputed in each, the
    state)."""
    from semseg_tpu_torch.models import resnet
    from semseg_tpu_torch.parallel import dropout_generator, train_step

    state = _train_model(torch, cfg, device, spatial=spatial)
    bands = len(spatial) * len(batches) if pooled else 0

    def run():
        out = []
        for i, b in enumerate(batches):
            before = resnet.RECOMPUTES
            m = train_step(state, b, dropout_generator(0, i))
            out.append((float(m["loss"]), float(m["acc"]), resnet.RECOMPUTES - before))
        return out

    out, _, dense, valid = _run_path(tag, run, ppm_pool, torch, band=bands, band_backward=bands)
    if (dense, valid) != (0, 0):
        raise RuntimeError(f"{tag}: pool launches dense {dense} / valid {valid}")
    return [o[:2] for o in out], [o[2] for o in out], state


def _state_tensors(state):
    """A train state's parameters, gradients and buffers, by name."""
    params = {k: p.detach() for k, p in state.model.named_parameters()}
    return {**params, **{k + " (gradient)": p.grad for k, p in state.model.named_parameters()},
            **dict(state.model.named_buffers())}


def _distance(torch, a, b):
    """(the names of the tensors that differ between two states' tensors,
    the largest max |a - b| / max |b| over them)."""
    differ = [k for k, v in b.items() if not torch.equal(a[k], v)]
    rel = max((float((a[k].double() - b[k].double()).abs().max()
                     / b[k].double().abs().max().clamp(min=1e-30)) for k in differ), default=0.0)
    return differ, rel


def spatial_remat_exact(torch, ppm_pool, card, lists, tag, path=CFG, steps=2,
                        one_thread=False):
    """(a), (b) and the multi-card check: ``steps`` float32 steps (TF32
    off, deterministic algorithms) of ``path``'s model at SPLIT_TRAIN split
    over each device list of ``lists``, with ``TPU.remat`` and without, from
    the same weights, batches and dropout generators: losses, accuracies,
    every parameter, gradient and buffer bit-equal, every block recomputed
    once a step with remat and none without, the band launches alike.

    Over several cards autograd runs each card's part of the backward on a
    thread of its own, and a tensor that takes gradients from several
    cards sums them in the order they arrive, so the split step is not
    bit-reproducible there (``spatial_remat_threads``): over cards
    ``one_thread`` turns multithreaded backward off (one thread issues
    every card's backward). Returns the band launches (each also a band
    backward launch)."""
    from semseg_tpu_torch.models import resnet

    dev0 = "cuda:0" if CARD == "cuda" else CARD
    cfgs = {remat: _cfg("TPU.compute_dtype", "float32", "TPU.remat", str(remat), path=path)
            for remat in (False, True)}
    pooled = cfgs[False].MODEL.arch_decoder in POOLED_DECODERS
    stride = cfgs[False].DATASET.segm_downsampling_rate
    batches = [_split_batch(torch, 17 + i, *SPLIT_TRAIN, dev0, stride) for i in range(steps)]
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    engine = "one backward thread" if one_thread else "default backward engine"
    launches = 0
    try:
        with _deterministic(torch), torch.autograd.set_multithreading_enabled(not one_thread):
            for spatial in lists:
                runs = [_remat_steps(torch, ppm_pool, f"{tag} {len(spatial)} bands, TPU.remat "
                                     f"{remat}, {engine}", cfgs[remat], batches, spatial, dev0,
                                     pooled) for remat in (False, True)]
                launches += 2 * len(spatial) * steps if pooled else 0
                (pm, prec, plain), (rm, rrec, remat) = runs
                blocks = sum(isinstance(m, resnet.ResBlock) for m in remat.model.modules())
                ref = _state_tensors(plain)
                differ, rel = _distance(torch, _state_tensors(remat), ref)
                it = float(remat.model.encoder.bn1._running_iter)
                want_it = 1.0
                for _ in range(steps):
                    want_it = want_it * 0.999 + 1
                print(f"{tag} {path.rsplit('/', 1)[-1]}, {len(spatial)} bands on "
                      f"{sorted(set(map(str, spatial)))}, {engine}, f32, TF32 off, "
                      f"deterministic, batch {SPLIT_TRAIN[0]} at {SPLIT_TRAIN[1]}x"
                      f"{SPLIT_TRAIN[2]}, {steps} steps, TPU.remat on against off: losses "
                      f"{[m[0] for m in rm]} / {[m[0] for m in pm]}, accuracies "
                      f"{[m[1] for m in rm]} / {[m[1] for m in pm]}; of {len(ref)} parameters, "
                      f"gradients and buffers {len(differ)} differ {differ[:3]}, largest "
                      f"relative difference {rel:.3e}; blocks recomputed a step {rrec} / {prec} ({blocks} blocks); stem "
                      f"iter {it:.6f} (want {want_it:.6f}); "
                      + (f"{len(spatial)} band forward and backward launches a step each run"
                         if pooled else "no pool launches") + f" (card: {card})", flush=True)
                if rm != pm or differ or rrec != [blocks] * steps or prec != [0] * steps \
                        or abs(it - want_it) >= 1e-5:
                    raise RuntimeError(f"TPU.remat over {spatial} ({engine}): the split remat "
                                       "step departs from the split step without it")
                del runs, plain, remat, ref
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return launches


def spatial_remat_threads(torch, ppm_pool, card, lists, tag):
    """The multi-card check's last part: one float32 step (TF32 off,
    deterministic algorithms, the default multithreaded backward) of the
    flagship at BENCH_TRAIN split over each device list of ``lists``, with
    ``TPU.remat`` and without, from the same weights, batch and dropout
    generator. Autograd runs each card's part of the backward on a thread
    of its own, so two threads may meet in a block's recompute, and a
    tensor that takes gradients from several cards sums them in the order
    they arrive: the forward (loss, accuracy, every BN buffer) must be
    bit-equal, each gradient within its SPATIAL_REMAT_THREAD_LIMITS
    (SPATIAL_REMAT_THREAD_REL for the others) in relative norm, and every
    block recomputed once."""
    dev0 = "cuda:0" if CARD == "cuda" else CARD
    cfgs = {remat: _cfg("TPU.compute_dtype", "float32", "TPU.remat", str(remat))
            for remat in (False, True)}
    batch = _split_batch(torch, 17, *BENCH_TRAIN, dev0)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with _deterministic(torch):
            for spatial in lists:
                (pm, prec, plain), (rm, rrec, remat) = [
                    _remat_steps(torch, ppm_pool, f"{tag} {len(spatial)} bands, TPU.remat "
                                 f"{remat}, multithreaded backward", cfgs[remat], [batch],
                                 spatial, dev0, True) for remat in (False, True)]
                params = dict(remat.model.named_parameters())
                grads = sorted(((float((params[k].grad - p.grad).norm() / p.grad.norm()), k)
                                for k, p in plain.model.named_parameters()), reverse=True)
                over = [(v, k) for v, k in grads
                        if not v <= SPATIAL_REMAT_THREAD_LIMITS.get(k, SPATIAL_REMAT_THREAD_REL)]
                buffers = dict(remat.model.named_buffers())
                differ = [k for k, b in plain.model.named_buffers()
                          if not torch.equal(buffers[k], b)]
                print(f"{tag} flagship, {len(spatial)} bands on {sorted(set(map(str, spatial)))}, "
                      f"multithreaded backward, f32, TF32 off, deterministic, batch "
                      f"{BENCH_TRAIN[0]} at {BENCH_TRAIN[1]}x{BENCH_TRAIN[2]}, one step, "
                      f"TPU.remat on against off: loss {rm[0][0]} / {pm[0][0]}, accuracy "
                      f"{rm[0][1]} / {pm[0][1]}; of {len(buffers)} BN buffers {len(differ)} "
                      f"differ; gradients' relative norm error, largest: "
                      + ", ".join(f"{k} {v:.3e}" for v, k in grads[:4])
                      + ", limited: " + ", ".join(
                          f"{k} {v:.3e} (limit {SPATIAL_REMAT_THREAD_LIMITS[k]})" for v, k in grads
                          if k in SPATIAL_REMAT_THREAD_LIMITS)
                      + f" (others {SPATIAL_REMAT_THREAD_REL}); {len(over)} of {len(grads)} over "
                      f"their limit; blocks recomputed {rrec} / {prec} (card: {card})", flush=True)
                if rm != pm or differ or over or rrec != [FLAGSHIP_BLOCKS] or prec != [0]:
                    raise RuntimeError(f"TPU.remat over {spatial} (multithreaded backward): the "
                                       f"split remat step departs from the split step without "
                                       f"it: {over[:3]}")
                del plain, remat, params, buffers
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return 2 * sum(map(len, lists))


def spatial_remat_cost(torch, ppm_pool, card):
    """(c): bf16 (default algorithms) ms/step (median of SPATIAL_REMAT_TIMED
    after a warm-up step), peak memory and the memory allocated between
    steps of the flagship split in bands on cuda:0, at each (shape, bands)
    of SPATIAL_REMAT_COST, remat off and on. Fails unless remat lowers the
    peak. Returns (the band launches, {(shape, bands): {remat: (ms, peak
    GiB, between-step GiB)}})."""
    import numpy as np

    from semseg_tpu_torch.parallel import dropout_generator, train_step

    dev0 = "cuda:0" if CARD == "cuda" else CARD
    steps = 1 + SPATIAL_REMAT_TIMED
    launches, out = 0, {}
    for shape, bands in SPATIAL_REMAT_COST:
        batch = _split_batch(torch, 16, *shape, dev0)
        row = {}
        for remat in (False, True):
            state = _train_model(torch, _cfg("TPU.remat", str(remat)), dev0,
                                 spatial=[dev0] * bands)

            def run():
                float(train_step(state, batch, dropout_generator(0, 0))["loss"])
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated() / 2**30
                seconds = []
                for i in range(1, steps):
                    tic = time.perf_counter()
                    float(train_step(state, batch, dropout_generator(0, i))["loss"])
                    seconds.append(time.perf_counter() - tic)
                return (float(np.median(seconds)) * 1e3,
                        torch.cuda.max_memory_allocated() / 2**30, base)

            row[remat], _, _, _ = _run_path(
                f"[spatial-remat] (c) batch {shape[0]} {shape[1]}x{shape[2]} in {bands} bands, "
                f"TPU.remat {remat}, {steps} steps", run, ppm_pool, torch,
                band=bands * steps, band_backward=bands * steps)
            launches += bands * steps
            del state
            torch.cuda.empty_cache()
        (pms, ppeak, pbase), (rms, rpeak, rbase) = row[False], row[True]
        print(f"[spatial-remat] (c) flagship bf16, batch {shape[0]} at {shape[1]}x{shape[2]} in "
              f"{bands} bands on {dev0}, median of {SPATIAL_REMAT_TIMED} steps after a "
              f"warm-up: remat off {pms:.1f} ms, peak {ppeak:.3f} GiB; remat on {rms:.1f} ms, "
              f"peak {rpeak:.3f} GiB (allocated between steps {pbase:.3f} / {rbase:.3f} GiB); "
              f"remat/plain: time {rms / pms:.3f}x, peak {rpeak / ppeak:.3f}x, peak above the "
              f"between-step allocation {(rpeak - rbase) / (ppeak - pbase):.3f}x (card: "
              f"{card})", flush=True)
        if not rpeak < ppeak:
            raise RuntimeError(f"TPU.remat did not lower the split step's peak at {shape} in "
                               f"{bands} bands: {rpeak} against {ppeak} GiB")
        out[(shape, bands)] = row
    return launches, out


def spatial_remat_phase(work, torch, ppm_pool, card, root, odgt):
    """Phase 15: (a)-(d) above. Returns (the band forward launches, each
    also a band backward launch; (c)'s measurements)."""
    start = time.perf_counter()
    dev0 = "cuda:0" if CARD == "cuda" else CARD
    launches = spatial_remat_exact(torch, ppm_pool, card, [[dev0] * 2, [dev0] * 4],
                                   "[spatial-remat] (a)")
    launches += spatial_remat_exact(torch, ppm_pool, card, [[dev0] * 2], "[spatial-remat] (b)",
                                    os.path.join(HERE, "config", ZOO_SPATIAL_CONFIGS[0]), 1)
    more, cost = spatial_remat_cost(torch, ppm_pool, card)
    launches += more + split_train_cli(work, torch, ppm_pool, root, odgt, card, remat=True)
    print(f"[spatial-remat] phase 15 took {time.perf_counter() - start:.1f} s; {launches} band "
          f"forward and {launches} band backward launches (card: {card})", flush=True)
    return launches, cost


def _remat_rank(rank, port, out, groups, backend):
    """Rank ``rank`` of ``spatial_remat_ranks`` (a spawned process): its
    bands on ``groups[rank]``, ``backend`` between the ranks, two float32
    steps (TF32 off, deterministic algorithms) without and then with remat
    from the same weights and batches, with multithreaded backward and with
    one backward thread. Saves each run's metrics, all-reduces and
    recomputes a step, and its state's digest."""
    import torch
    import torch.distributed as dist

    from semseg_tpu_torch.models import resnet
    from semseg_tpu_torch.parallel import distributed, dropout_generator, train_step

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    devices = groups[rank]
    device = distributed.initialize(f"127.0.0.1:{port}", len(groups), rank, backend=backend,
                                    device=devices[0], timeout=SPATIAL_REMAT_TIMEOUT // 2)
    real, calls = dist.all_reduce, []
    dist.all_reduce = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        batches = [_split_batch(torch, 30 + 2 * i + rank, *SPLIT_TRAIN, device)
                   for i in range(2)]
        result = {}
        for threads in (True, False):
            with _deterministic(torch), torch.autograd.set_multithreading_enabled(threads):
                for remat in (False, True):
                    state = _train_model(torch, _cfg("TPU.compute_dtype", "float32",
                                                     "TPU.remat", str(remat)), device,
                                         group=dist.group.WORLD, spatial=devices)
                    run = {"metrics": [], "all_reduces": [], "recomputes": []}
                    for i, b in enumerate(batches):
                        calls.clear()
                        before = resnet.RECOMPUTES
                        m = train_step(state, b, dropout_generator(0, i))
                        run["metrics"].append((float(m["loss"]), float(m["acc"])))
                        run["all_reduces"].append(len(calls))
                        run["recomputes"].append(resnet.RECOMPUTES - before)
                    run["digest"] = _digest(_state_tensors(state))
                    result[threads, remat] = run
                    del state
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.all_reduce = real
        distributed.shutdown()


def spatial_remat_ranks(work, torch, card, groups, backend="nccl"):
    """The multi-card check's ranks: a rank over each device list of
    ``groups`` (``_remat_rank``), remat on against off: each rank's
    metrics and state bit-equal between the runs and equal to rank 0's,
    as many all-reduces a step with remat as without, every block
    recomputed once a step. A rank that has not ended within
    SPATIAL_REMAT_TIMEOUT (a mismatched collective hangs) is killed and the
    check fails."""
    from semseg_tpu_torch.parallel import distributed

    out = os.path.join(work, "spatial_remat_ranks")
    os.makedirs(out)
    tic = time.perf_counter()
    world = len(groups)
    ctx = torch.multiprocessing.spawn(_remat_rank, args=(distributed.free_port(), out, groups,
                                                         backend), nprocs=world, join=False)
    while not ctx.join(timeout=5):
        if time.perf_counter() - tic > SPATIAL_REMAT_TIMEOUT:
            for proc in ctx.processes:
                proc.kill()
            raise RuntimeError(f"{world} ranks over {groups} with TPU.remat did not end within "
                               f"{SPATIAL_REMAT_TIMEOUT} s (mismatched collectives?)")
    wall = time.perf_counter() - tic
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(world)]
    for r, got in enumerate(ranks):
        for threads in (True, False):
            plain, remat = got[threads, False], got[threads, True]
            engine = "multithreaded backward" if threads else "one backward thread"
            print(f"[multi] spatial remat, rank {r} of {world} {backend} ranks, its bands on "
                  f"{groups[r]}, {engine}, f32, TF32 off, deterministic, batch "
                  f"{SPLIT_TRAIN[0]} at {SPLIT_TRAIN[1]}x{SPLIT_TRAIN[2]} a rank, 2 steps: "
                  f"losses {[m[0] for m in remat['metrics']]} / "
                  f"{[m[0] for m in plain['metrics']]} (remat on / off); all-reduces a step "
                  f"{remat['all_reduces']} / {plain['all_reduces']}; blocks recomputed a step "
                  f"{remat['recomputes']} / {plain['recomputes']}; state digest equal between "
                  f"the runs {remat['digest'] == plain['digest']}, to rank 0's "
                  f"{remat['digest'] == ranks[0][threads, True]['digest']}; {wall:.1f} s from "
                  f"spawn to exit (card: {card})", flush=True)
            # With multithreaded backward the runs are not bit-reproducible
            # (spatial_remat_threads): their forward is.
            same = (remat["digest"] == plain["digest"] and remat["metrics"] == plain["metrics"]
                    if not threads else remat["metrics"][0] == plain["metrics"][0])
            if (not same or remat["all_reduces"] != plain["all_reduces"]
                    or remat["recomputes"] != [FLAGSHIP_BLOCKS] * 2
                    or plain["recomputes"] != [0, 0]
                    or remat["digest"] != ranks[0][threads, True]["digest"]):
                raise RuntimeError(f"rank {r} ({engine}): the split remat step departs from "
                                   "the split step without it, or from rank 0")


def spatial_remat_multi_card(work, torch, ppm_pool, card, root, odgt, n):
    """The multi-card check's part of phase 15: (a) with the bands over
    cuda:0-1 and cuda:0-3 and one backward thread, the ranks (four cards or
    more), ``cli.train --devices n/2 ... TPU.spatial 2 TPU.remat True`` for
    one epoch in a process of its own, killed after SPATIAL_REMAT_TIMEOUT,
    and last the multithreaded backward (``spatial_remat_threads``)."""
    import signal

    import numpy as np

    start = time.perf_counter()
    lists = [[f"cuda:{j}" for j in range(b)] for b in (2, 4) if b <= n]
    spatial_remat_exact(torch, ppm_pool, card, lists, "[multi] spatial remat,", one_thread=True)
    if n >= 4:
        spatial_remat_ranks(work, torch, card, [["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]])
    out = os.path.join(work, "multi_spatial_remat_train")
    tic = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "semseg_tpu_torch.cli.train", "--cfg", CFG, "--devices",
         str(n // 2), *([] if CARD == "cuda" else ["--device", CARD]), "DIR", out,
         *_train_cfg_opts(root, odgt), "TRAIN.num_epoch", "1", "TRAIN.disp_iter", "1",
         "TRAIN.workers", "1", "TPU.spatial", "2", "TPU.remat", "True"],
        cwd=HERE, start_new_session=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        log, _ = proc.communicate(timeout=SPATIAL_REMAT_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"cli.train TPU.spatial 2 TPU.remat True over {n} cards did not end "
                           f"within {SPATIAL_REMAT_TIMEOUT} s")
    wall = time.perf_counter() - tic
    losses = []
    if proc.returncode == 0:
        with open(os.path.join(out, "history_epoch_1.json")) as f:
            losses = json.load(f)["train"]["loss"]
    if proc.returncode or len(losses) != TRAIN_ITERS or not np.all(np.isfinite(losses)) \
            or not os.path.exists(os.path.join(out, "encoder_epoch_1.pth")):
        raise RuntimeError(f"cli.train TPU.spatial 2 TPU.remat True over {n} cards: exit "
                           f"{proc.returncode}, losses {losses}; its log ends {log[-2000:]}")
    print(f"[multi] cli.train TPU.spatial 2 TPU.remat True over {n} cards ({n // 2} data "
          f"group(s) of 2 cards): {TRAIN_ITERS} steps at batch 2 per group, bf16, full width; "
          f"per-step global losses {losses}; {wall:.1f} s wall (its own process, spawn, model "
          f"builds and the checkpoint included; card: {card})", flush=True)
    spatial_remat_threads(torch, ppm_pool, card, lists, "[multi] spatial remat,")
    print(f"[multi] the spatial remat check took {time.perf_counter() - start:.1f} s (card: "
          f"{card})", flush=True)


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--compare", default=None, metavar="PATH",
                        help="also time a library built from this ppm_pool.cu against "
                             "the checkout's, in turns (phase 4)")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "runs on a CUDA card only", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import semseg_tpu_torch
    from semseg_tpu_torch.ops.kernels import ppm_pool

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(semseg_tpu_torch.__file__)))
    if pkg != HERE:
        raise RuntimeError(f"semseg_tpu_torch imported from {pkg}, not from {HERE}")

    name = torch.cuda.get_device_name(0)
    card = _card_line()
    print(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"nvidia-smi: {card}", flush=True)

    start = tic = time.perf_counter()
    ppm_pool._lib()
    print(f"[build] ppm_pool.cu built/loaded in {time.perf_counter() - tic:.2f} s", flush=True)
    print_build(ppm_pool)
    compare = None
    if args.compare:
        from semseg_tpu_torch.ops.kernels._build import load_library

        compare = ppm_pool.declare(load_library("ppm_pool_compare", [os.path.abspath(args.compare)]))
        print(f"[build] {args.compare} built/loaded for the comparison", flush=True)

    # The band form first: its check is the quickest proof that the
    # source built.
    band_err = check_band_kernel(ppm_pool, torch)
    max_err = check_kernel(ppm_pool, torch)
    valid_err = check_valid_kernel(ppm_pool, torch)
    backward_err = check_backward_kernel(ppm_pool, torch)
    if compare is not None:
        check_backward_against(ppm_pool, torch, compare)
    times = time_kernel(ppm_pool, torch, card, compare)
    backward_times = time_backward(ppm_pool, torch, card, compare)
    bn = bn_act_phase(torch, card)

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as work:
        ckpt, val_dir, odgt, launches = main_path(work, torch, ppm_pool)
        zoo_launches, zoo_ckpts = zoo_phase(work, torch, ppm_pool)
        serve_launches = serving_phase(work, ckpt, torch, ppm_pool, card)
        for form in ("dense", "valid"):
            launches[form] += zoo_launches[form] + serve_launches[form]
        steady_state(ckpt, val_dir, odgt, torch, card)
        card_vs_cpu(ckpt, torch)
        batched_f32(ckpt, work, torch)
        levels_vs_pil(work, torch)
        dp_vs_host_f32(ckpt, val_dir, odgt, torch)
        zoo_card_vs_cpu(zoo_ckpts, torch)
        train_launches, train_root, train_odgt = train_phase(work, torch, ppm_pool, card)
        for form in ("dense", "valid"):
            launches[form] += train_launches[form]
        loss_falls(torch, train_root, train_odgt, card)
        train_card_vs_cpu(torch, ppm_pool)
        fix_bn_launches = fix_bn_step(torch, card)
        train_steady_state(torch, card)
        dp_launches = data_parallel_phase(work, torch, ppm_pool, card, ckpt, val_dir, odgt,
                                          train_root, train_odgt)
        for form in ("dense", "valid"):
            launches[form] += dp_launches[form]
        slice_launches = slice_phase(work, torch, ppm_pool, card, ckpt, val_dir, odgt,
                                     train_root, train_odgt)
        for form in ("dense", "valid"):
            launches[form] += slice_launches[form]
        band_launches, _, band_times = spatial_phase(work, torch, ppm_pool, card, ckpt,
                                                     val_dir, odgt, compare)
        split_launches, band_backward_err, band_backward_times, _, train_band_err = \
            spatial_train_phase(work, torch, ppm_pool, card, train_root, train_odgt, compare)
        print(f"[spatial] band launches: phase 12 {band_launches}; phase 13 {split_launches} "
              f"band and {split_launches} band backward", flush=True)
        zoo_band, zoo_backward, zoo_band_err, zoo_backward_err, zoo_band_times, \
            zoo_backward_times = spatial_zoo_phase(work, torch, ppm_pool, card, zoo_ckpts,
                                                   val_dir, odgt, train_root, train_odgt,
                                                   compare)
        remat_launches, _ = spatial_remat_phase(work, torch, ppm_pool, card, train_root,
                                                train_odgt)
        band_launches += split_launches + zoo_band + remat_launches
        split_launches += zoo_backward + remat_launches
        band_err = max(band_err, train_band_err, zoo_band_err)
        band_backward_err = max(band_backward_err, zoo_backward_err)
        if torch.cuda.device_count() > 1:
            multi_card_phase(work, torch, ppm_pool, card, ckpt, val_dir, odgt, train_root,
                             train_odgt, zoo_ckpts)

    def timed(case):
        return dict(zip(("ms", "cold_ms", "plain_ms", "bound_ms", "bound_by", "device_ms"), case))

    def numbers(case):
        # bf16 at the first timed case of the form; no single PyTorch call
        # computes the four grids, so there is no library time.
        warm, cold, plain, bound, bound_by = times[(*case[:2], "bfloat16")]
        return dict(ms=warm, cold_ms=cold, plain_ms=plain, bound_ms=bound,
                    bound_by=bound_by, library_ms=None)

    print(f"[done] all phases passed in {time.perf_counter() - start:.1f} s from the build on",
          flush=True)
    bn_warm, bn_cold, bn_plain, bn_bound, bn_device = bn["times"][
        (BN_ACT_TIMED[0][0], "bfloat16")]
    entry = dict(route="cuda", source="semseg_tpu_torch/csrc/ppm_pool.cu")
    print(json.dumps({"kernels": [
        {"name": "pyramid_pool", **entry, "replaces": "semseg_tpu/ops/pallas/ppm_pool.py:40",
         "launches": launches["dense"], "max_abs_err": max_err, **numbers(TIME_CASES[0])},
        {"name": "pyramid_pool_valid", **entry,
         "replaces": "semseg_tpu/ops/resize_dynamic.py:70",
         "launches": launches["valid"], "max_abs_err": valid_err, **numbers(TIME_CASES[1])},
        {"name": "pyramid_pool_backward", **entry,
         # No Pallas backward exists: JAX differentiates XLA's pool here.
         "replaces": "semseg_tpu/ops/pool.py:55",
         "launches": (train_launches["backward"] + dp_launches["backward"]
                      + slice_launches["backward"]),
         "max_abs_err": backward_err, **timed(backward_times[(BACKWARD_TIMED[0], "bfloat16")]),
         "library_ms": None,
         # The flagship's own batch-2 training map, bf16.
         "at_2x40x56x2048": timed(backward_times[((2, 40, 56, 2048), "bfloat16")])},
        {"name": "pyramid_pool_band", **entry,
         # The band form of the same pool: the JAX package lets GSPMD split
         # the pool's sums over the sharded height.
         "replaces": "semseg_tpu/ops/pallas/ppm_pool.py:40",
         "launches": band_launches, "max_abs_err": band_err,
         # bf16, the first of 2 bands; no single PyTorch call computes the
         # sums.
         **timed(band_times[(2, "bfloat16")]), "library_ms": None,
         # UPerNet's stride-32 conv5 of a 600x800 canvas (phase 14).
         "at_1x19x25x2048": timed(zoo_band_times[(2, "bfloat16")])},
        {"name": "pyramid_pool_band_backward", **entry,
         # No Pallas backward exists: under the hybrid mesh JAX
         # differentiates XLA's pool over the sharded height.
         "replaces": "semseg_tpu/ops/pool.py:55",
         "launches": split_launches, "max_abs_err": band_backward_err,
         # bf16, the first of 2 bands of the flagship's batch-2 training
         # map; no single PyTorch call computes a band's input gradient.
         **timed(band_backward_times[(BAND_BACKWARD_TIMED[0][0], 2, "bfloat16")]),
         "library_ms": None,
         # UPerNet's batch-2 training conv5 at 448x608 (phase 14).
         "at_2x14x19x2048": timed(zoo_backward_times[((2, 14, 19, 2048), 2, "bfloat16")])},
        # No TPU kernel: the JAX package leaves batch norm to XLA. bf16, a
        # block's last BN (residual and ReLU) at the flagship's batch-8 map.
        {"name": "bn_act", "route": "cuda", "source": "semseg_tpu_torch/csrc/bn_act.cu",
         "replaces": None,
         "launches": (launches["bn"] + zoo_launches["bn"] + serve_launches["bn"]
                      + fix_bn_launches),
         "max_abs_err": bn["max_err"], "ms": bn_warm, "cold_ms": bn_cold, "plain_ms": bn_plain,
         "bound_ms": bn_bound, "bound_by": "bytes",
         "device_ms": None if bn_device is None else bn_device / 1e3, "library_ms": None,
         "host_us": bn["host"]},
    ]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
