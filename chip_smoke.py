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
   one: other, this, this, other;
5. the main paths at full width: the flagship resnet50dilated + ppm_deepsup
   with seeded random weights saved as a reference ``.pth`` pair, through
   ``cli.test`` (3 images, bucketed per-image engine), ``cli.eval --exact``,
   the default ``cli.eval`` (batched engine: batch 4, packed buckets,
   on-device metrics) and ``cli.eval --device-pyramid`` (levels derived on
   the card from the originals) over the same 9 labelled images, all 5
   scales; then every other shipped config (the zoo) through the default
   ``cli.eval`` (3 labelled images) and ``cli.test`` (1 image) at full
   width and its own scales. The launch counts are read per path: the
   pad-aware form once per level in ``cli.test`` and once per scheduled
   chunk in the default and device-pyramid ``cli.eval`` (none in the C1
   configs), the dense form once per level in ``cli.eval --exact``; the
   three flagship eval paths must count the same labelled pixels;
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
   on one repeated batch; one float32 step (TF32 off) on the card against
   the CPU from the same weights and batch (loss, the gradients of layer4's
   last conv, a PPM branch conv and ``conv_last``, the BN statistics: a
   missing pool gradient moves layer4's by O(1)); and steady state at
   bench.py's train shape (batch 8, 448x608) with peak memory at batch 2
   and 8 and a ``torch.profiler`` step broken down by kernel;
9. serving (run after the zoo phase): ``tools.export_serving`` exports the
   flagship (bf16) as a bundle of two buckets (448x608, 608x448) at batch
   4 on the card, with its export time and file sizes (each program file
   at most 5% of ``params.pt``); each program against the eager forward
   (argmax agreement) with one dense launch per program call; an f32
   bundle exported on the card against the same bundle exported on the CPU
   (TF32 off); then ``cli.serve`` on 127.0.0.1 over the bundle and over
   the live engine (5 scales, batch 8, packed): ``/healthz``, then 16 JPEG
   requests of shapes sampled from ``data/validation.odgt``, sent twice per
   round from 1, 4, 8 and 16 client threads, with req/s, mean batch fill,
   the server's latency percentiles (enqueue to result) and the client's
   (decode, pyramid and HTTP included) per round; every answer 200, and at one
   client each label map equal to the backend's own prediction of the
   decoded image; last, the live server with ``--max-queue 2`` under 16
   concurrent requests must answer some 503 and no 500.

It ends with a JSON line of per-kernel results, the card's ``nvidia-smi``
name and power limit, and ``{"ok": true, "device": {...}}`` as the last
line. Any failure raises, so the exit code is non-zero and no result line
is printed. It never falls back to the CPU.
"""

from __future__ import annotations

import json
import os
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


def _pass_us(ppm_pool, torch, x, v, flush):
    """Mean device time (us) of each of the kernel's two passes over 10
    cold calls, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            flush.sum()
            ppm_pool.launch(ppm_pool._lib(), x, v)
        torch.cuda.synchronize()
    return {name: e.self_device_time_total / e.count
            for e in prof.key_averages()
            for name in ("ppm_cells_kernel", "ppm_combine_kernel") if name in e.key}


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
                runs = []
                for who, lib in (("other", compare), ("this", this), ("this", this),
                                 ("other", compare)):
                    def call():
                        return ppm_pool.launch(lib, x, v)
                    runs.append(f"{who} {_median_ms(call, torch, flush):.4f} cold / "
                                f"{_median_ms(call, torch):.4f} warm")
                print(f"[compare] {form} {shape} {dt} (ms): " + "; ".join(runs) +
                      f" (card: {card})", flush=True)
    return out


def print_build(ppm_pool):
    """Registers and spills of every kernel from the build's ptxas output;
    raises on a spill."""
    import re

    from semseg_tpu_torch.ops.kernels._build import build_log

    log = build_log("ppm_pool", ppm_pool.SOURCES)
    kernel, spills, kernels = None, None, 0
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
            short = re.sub(r"^_ZN\w*?_ppm_pool_cu_\w{8}\d+", "", kernel)[:60]
            smem = re.search(r"(\d+) bytes smem", line)
            print(f"[build] ptxas: {short}: {m.group(1)} registers, "
                  f"{smem.group(1) if smem else 0} bytes shared memory, spill stores/loads "
                  f"{spills[0]}/{spills[1]} bytes", flush=True)
            if any(spills):
                raise RuntimeError(f"{kernel} spills registers: {spills}")
            kernel = None
    if kernels == 0:
        raise RuntimeError("the build log holds no ptxas report")


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


def expected_chunks(cfg, val_dir, odgt, batch=4, *, flagship=True):
    """Chunks the batched engine schedules for the val set (one call of
    <= 32 images), counted from its own schedule."""
    from semseg_tpu_torch.engine import BatchedInferenceEngine

    pyrs, labels = _val_items(cfg, val_dir, odgt)
    eng = _plan_engine(BatchedInferenceEngine, cfg, batch)
    windows = eng._canvas_windows([lab.shape for lab in labels], range(len(pyrs)))
    chunks = 0
    for window in windows:
        groups = eng._group_by_bucket([pyrs[i] if i in window else [] for i in range(len(pyrs))])
        fill = sorted((k, len(t), len({x[0] for x in t})) for k, t in groups.items())
        folded = sum(eng._bucket_key(h, w) != k for k, t in groups.items() for *_, h, w in t)
        if flagship:
            print(f"[main] window of {len(window)} images: buckets (key, tasks, images) {fill}; "
                  f"{folded} tasks packed into a larger bucket", flush=True)
            shared = [f for f in fill if f[2] > 1]
            padded = [f for f in fill if f[1] % batch]
            if not shared or not padded:
                raise RuntimeError("the eval images must share a bucket and pad a last chunk")
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


def _run_path(name, fn, ppm_pool, torch, backward=0):
    """Drive one path with the launch counts set to 0; returns (result,
    seconds, dense launches, valid launches). The backward kernel must
    launch ``backward`` times."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ppm_pool.LAUNCHES = 0
    ppm_pool.VALID_LAUNCHES = 0
    ppm_pool.BACKWARD_LAUNCHES = 0
    tic = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - tic
    dense, valid = ppm_pool.LAUNCHES, ppm_pool.VALID_LAUNCHES
    print(f"[main] {name}: pyramid_pool launches dense {dense}, valid_hw {valid}, backward "
          f"{ppm_pool.BACKWARD_LAUNCHES}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if ppm_pool.BACKWARD_LAUNCHES != backward:
        raise RuntimeError(f"{name}: {ppm_pool.BACKWARD_LAUNCHES} backward launches, "
                           f"expected {backward}")
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
        (miou, acc, _, raw), wall_s, dense, valid = _run_path(name, lambda: eval_cli.main(
            ["--cfg", CFG, *flags, "DIR", ckpt, *data]), ppm_pool, torch)
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

    val_dir = os.path.join(work, "zoo_val")
    odgt = _write_val_set(val_dir, ZOO_IMAGES, seed=4)
    test_dir = os.path.join(work, "zoo_test")
    os.makedirs(test_dir)
    _write_images(test_dir, ZOO_IMAGES[:1], np.random.RandomState(5))
    data = ["DATASET.root_dataset", val_dir, "DATASET.list_val", odgt]
    launches, ckpts = {"dense": 0, "valid": 0}, {}
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
        (miou, acc, _, raw), eval_s, dense, valid = _run_path(
            f"zoo {tag}: cli.eval", lambda: eval_cli.main(
                ["--cfg", path, "DIR", ckpt, *data]), ppm_pool, torch)
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
    builder = PyramidBuilder(cfg.DATASET, bucket_step=cfg.TPU.eval_bucket_step)
    tic = time.perf_counter()
    for ori in oris:
        builder.multi_scale_pyramid(ori, raw=True)
    host_s = (time.perf_counter() - tic) / len(oris)
    print(f"[steady] host PIL pyramid (5 uint8 levels on the step-8 lattice), one thread of "
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
    pool = [e for e in kernels if "ppm_cells_kernel" in e.key or "ppm_combine_kernel" in e.key]
    pool_ms = sum(dev_ms(e) for e in pool)
    print(f"[profile] pyramid_pool in the {name} pass: {pool_ms:.3f} ms of device time "
          f"({pool_ms / busy_ms:.2%}) over " + ", ".join(
              f"{e.count} x {'ppm_cells_kernel' if 'ppm_cells' in e.key else 'ppm_combine_kernel'}"
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


def time_backward(ppm_pool, torch, card) -> dict:
    """Phase 8: (warm ms, cold ms, plain ms, bound ms, bound_by) of the
    backward kernel per timed shape and dtype."""
    from torch.profiler import ProfilerActivity, profile

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
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    flush.sum()
                    run()
                torch.cuda.synchronize()
            dev = [e.self_device_time_total / e.count for e in prof.key_averages()
                   if "ppm_pool_backward_kernel" in e.key]
            out[(shape, dt)] = (warm, cold, plain, bound, bound_by)
            print(f"[time] pyramid_pool backward {shape} {dt}: kernel {warm:.4f} ms warm, "
                  f"{cold:.4f} ms cold; bound {bound:.4f} ms ({bound_by}), share of bound "
                  f"{bound / cold:.3f} cold, {bound / warm:.3f} warm; kernel under the profiler "
                  f"(cold) {dev[0] if dev else float('nan'):.2f} us; plain {plain:.4f} ms "
                  f"(median of 50; card: {card})", flush=True)
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
            name, lambda: train_cli.main(["--cfg", CFG, *opts, *extra]), ppm_pool, torch,
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


def _train_model(torch, cfg, device, seed=0):
    from semseg_tpu_torch.models import ModelBuilder
    from semseg_tpu_torch.parallel import create_train_state

    model = ModelBuilder.build_model(cfg, device=device, seed=seed)
    return create_train_state(cfg, model.train())


def loss_falls(torch, root, odgt, card):
    """Five steps on one repeated batch of the written set: the loss falls."""
    from semseg_tpu_torch.data import TrainDataset
    from semseg_tpu_torch.parallel import dropout_generator, train_step

    cfg = _cfg(*_train_cfg_opts(root, odgt))
    state = _train_model(torch, cfg, CARD)
    host = TrainDataset(root, odgt, cfg.DATASET, batch_per_gpu=2, seed=1,
                        bucket_step=cfg.TPU.bucket_step, raw_transport=True).next_batch()
    batch = {k: torch.from_numpy(v).to(CARD) for k, v in host.items()}
    losses = [float(train_step(state, batch, dropout_generator(0, i))["loss"]) for i in range(5)]
    print(f"[train] one repeated batch {tuple(host['img_data'].shape)}, 5 steps: losses "
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
    ("pool forward", ("ppm_cells_kernel", "ppm_combine_kernel")),
    ("pool backward", ("ppm_pool_backward_kernel",)),
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


def _serve_traffic(name, server, bodies, refs, agree, card):
    """Request rounds at each concurrency against a bound server, after a
    warm round; ``bodies`` are the requests of one round and ``refs`` the
    backend's own label map of each decoded image, predicted alone. Every
    answer must be 200. At one client each request is alone in its batch,
    so its label map must equal its reference. With more clients each map
    must agree with its own reference within ``agree`` (None: more than
    with the reference of any other request of its shape; the live
    engine's packing may fold a level into a larger bucket with co-batched
    requests, whose extra zero pad the convolutions carry in). Returns the
    batches the backend ran."""
    import io
    import urllib.request

    import numpy as np

    url = f"http://127.0.0.1:{server.server_address[1]}"
    server.serve_background()
    with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
        health = json.load(resp)
    print(f"[serve] {name}: /healthz {health}", flush=True)
    if health["status"] != "ok":
        raise RuntimeError(f"{name}: /healthz {health}")
    _post_all(url + "/segment?format=npy", bodies, max(SERVE_CONCURRENCY))
    batches = 0
    for conc in SERVE_CONCURRENCY:
        server.batcher.reset_stats()
        wall, results = _post_all(url + "/segment?format=npy", bodies, conc)
        with urllib.request.urlopen(url + "/stats", timeout=60) as resp:
            stats = json.load(resp)
        bad = [st for st, _, _ in results if st != 200]
        lats = [t * 1e3 for _, t, _ in results]
        maps = [np.load(io.BytesIO(p)) for st, _, p in results if st == 200]
        shares = [float((m == r).mean()) if m.shape == r.shape else 0.0
                  for m, r in zip(maps, refs)]
        others = [max([float((m == r).mean()) for r in refs
                       if r.shape == m.shape and r is not own], default=0.0)
                  for m, own in zip(maps, refs)]
        print(f"[serve] {name}, {conc} client(s), {len(bodies)} requests: "
              f"{len(bodies) / wall:.2f} req/s, mean_batch_fill {stats['mean_batch_fill']:.2f} "
              f"({stats['batches']} batches), /stats latency p50 {stats['latency_ms_p50']:.1f} / "
              f"p95 {stats['latency_ms_p95']:.1f} ms, client p50 {_pct(lats, 0.5):.1f} / p95 "
              f"{_pct(lats, 0.95):.1f} / max {max(lats):.1f} ms, non-200 {len(bad)}; each map "
              f"against its request predicted alone: agreement min "
              f"{min(shares, default=0.0):.6f} (closest other request max "
              f"{max(others, default=0.0):.6f}); card: {card}", flush=True)
        if bad or stats["errors"] or stats["requests"] != len(bodies):
            raise RuntimeError(f"{name}, {conc} clients: statuses {bad}, stats {stats}")
        if len(shares) != len(bodies) or min(shares) < (1.0 if conc == 1 else agree or 0.0) \
                or (agree is None and any(a <= b for a, b in zip(shares, others))):
            raise RuntimeError(f"{name}, {conc} clients: a label map departs from the "
                               f"backend's own: agreement {shares}, with the closest other "
                               f"request's {others}")
        batches += stats["batches"]
    return batches


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
    import io

    import numpy as np
    from PIL import Image

    from semseg_tpu_torch.checkpoint import resolve_reference_checkpoint
    from semseg_tpu_torch.cli import serve as serve_cli
    from semseg_tpu_torch.data.dataset import sample_odgt_shapes
    from semseg_tpu_torch.models import ModelBuilder
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
        got = pred.predict_batch(imgs)
        torch.cuda.synchronize()
        if ppm_pool.LAUNCHES != 1:
            raise RuntimeError(f"program {b}x{h}x{w}: {ppm_pool.LAUNCHES} dense launches")
        with torch.no_grad():
            x = normalize_255(torch.from_numpy(np.stack(imgs)).to("cuda", torch.float32))
            logits = model(x.permute(0, 3, 1, 2))
            want = resize_bilinear(logits.to(torch.float32), (h, w)).argmax(dim=1).cpu().numpy()
        shares = [float((g == wm).mean()) for g, wm in zip(got, want)]
        print(f"[serve] program {b}x{h}x{w} against the eager forward (bf16): argmax "
              f"agreement {min(shares):.6f} (limit {AGREE}), 1 dense launch per call", flush=True)
        if min(shares) < AGREE:
            raise RuntimeError(f"program {b}x{h}x{w} disagrees with the eager forward: {shares}")
    del model
    mixed = [np.zeros((448, 608, 3), np.uint8)] * 5 + [np.zeros((608, 448, 3), np.uint8)] * 2
    ppm_pool.LAUNCHES = 0
    pred.predict_batch(mixed)
    if ppm_pool.LAUNCHES != 3:  # 5 landscape images in 2 calls, 2 portrait ones in 1
        raise RuntimeError(f"7 mixed images: {ppm_pool.LAUNCHES} dense launches, expected 3")
    serving_f32(work, ckpt, torch, Predictor, export_serving)

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
    launches = {"dense": 0, "valid": 0}

    refs = [pred.predict(d) for d in decoded]
    batches, _, dense, valid = _run_path("cli.serve --bundle traffic", lambda: _serve_traffic(
        "bundle", server, bodies * 2, refs * 2, AGREE, card), ppm_pool, torch)
    server.close()
    if not (batches <= dense <= 2 * batches and valid == 0):
        raise RuntimeError(f"bundle traffic: {batches} batches, launches dense {dense} / "
                           f"valid {valid}")
    launches["dense"] += dense

    server, (live,) = serve_cli.build_server(
        ["--cfg", CFG, "--host", "127.0.0.1", "--port", "0", "--quiet", "--max-batch", "8",
         "DIR", ckpt])
    refs = [live.predict_batch([d])[0] for d in decoded]
    _, _, dense, valid = _run_path("cli.serve --cfg (live) traffic", lambda: _serve_traffic(
        "live 5 scales", server, bodies * 2, refs * 2, None, card), ppm_pool, torch)
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

    max_err = check_kernel(ppm_pool, torch)
    valid_err = check_valid_kernel(ppm_pool, torch)
    backward_err = check_backward_kernel(ppm_pool, torch)
    times = time_kernel(ppm_pool, torch, card, compare)
    backward_times = time_backward(ppm_pool, torch, card)

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
        train_steady_state(torch, card)

    def numbers(case):
        # bf16 at the first timed case of the form; no single PyTorch call
        # computes the four grids, so there is no library time.
        warm, cold, plain, bound, bound_by = times[(*case[:2], "bfloat16")]
        return dict(ms=warm, cold_ms=cold, plain_ms=plain, bound_ms=bound,
                    bound_by=bound_by, library_ms=None)

    print(f"[done] all phases passed in {time.perf_counter() - start:.1f} s from the build on",
          flush=True)
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
         "launches": train_launches["backward"], "max_abs_err": backward_err,
         **dict(zip(("ms", "cold_ms", "plain_ms", "bound_ms", "bound_by"),
                    backward_times[(BACKWARD_TIMED[0], "bfloat16")])), "library_ms": None},
    ]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
