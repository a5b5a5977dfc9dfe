#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``semseg_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA. In order:

1. device: the card's name and power limit;
2. build: the CUDA kernels from ``semseg_tpu_torch/csrc`` (nvcc, sm_90a);
3. each kernel against its plain PyTorch version at the main path's shapes:
   ``pyramid_pool`` dense, and its pad-aware form (``valid_hw``) on batches
   with mixed per-sample extents, in float32 and bfloat16;
4. kernel and plain times (CUDA events, 10 warm-up runs, median of 50);
5. the main paths at full width: the flagship resnet50dilated + ppm_deepsup
   with seeded random weights saved as a reference ``.pth`` pair, through
   ``cli.test`` (3 images, bucketed per-image engine), ``cli.eval --exact``
   and the default ``cli.eval`` (batched engine: batch 4, packed buckets,
   on-device metrics) over the same 9 labelled images, all 5 scales. The
   launch counts are read per path: the pad-aware form once per level in
   ``cli.test`` and once per scheduled chunk in the default ``cli.eval``,
   the dense form once per level in ``cli.eval --exact``;
6. steady state of the batched and exact engines on those images, and a
   ``torch.profiler`` breakdown of one batched pass;
7. float32 with TF32 off: card against CPU (exact engine); the batched
   engine's device metrics against host metrics of its maps, and its maps,
   packed and unpacked, against the per-image bucketed engine.

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
CHECK_SHAPES = [
    ((1, 75, 100, 2048), "float32"), ((1, 75, 100, 2048), "bfloat16"),
    ((1, 38, 50, 2048), "float32"), ((1, 38, 50, 2048), "bfloat16"),
    ((2, 13, 17, 256), "float32"), ((1, 1, 1, 2048), "bfloat16"),
    ((1, 75, 100, 720), "bfloat16"),
]
# Pad-aware form: a batch-8 canvas with mixed extents (full, odd, 1x1,
# full height or width only), and smaller canvases of the main path.
VALID_SHAPE = (8, 75, 100, 2048)
VALID_CHECKS = [
    (VALID_SHAPE, [[75, 100], [75, 99], [37, 51], [1, 1], [60, 100], [75, 13],
                   [49, 67], [2, 3]]),
    ((4, 38, 50, 2048), [[38, 50], [33, 41], [38, 7], [19, 50]]),
    ((2, 13, 17, 256), [[13, 17], [7, 9]]),
]
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


def check_kernel(ppm_pool, torch) -> float:
    max_err = 0.0
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape, dt in CHECK_SHAPES:
        dtype = getattr(torch, dt)
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        outs = ppm_pool.pyramid_pool(x)
        refs = ppm_pool.pyramid_pool_plain(x)
        for o, r in zip(outs, refs):
            torch.testing.assert_close(o.float(), r.float(), **_tolerance(dtype))
            max_err = max(max_err, (o.float() - r.float()).abs().max().item())
        print(f"[check] pyramid_pool {shape} {dt}: ok", flush=True)
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
            outs = ppm_pool.pyramid_pool(x, valid_hw=v)
            refs = ppm_pool.pyramid_pool_plain(x, valid_hw=v)
            for o, r in zip(outs, refs):
                torch.testing.assert_close(o.float(), r.float(), **_valid_tolerance(dtype))
                max_err = max(max_err, (o.float() - r.float()).abs().max().item())
            print(f"[check] pyramid_pool valid_hw {shape} {dt} extents {extents}: ok",
                  flush=True)
    torch.cuda.synchronize()
    return max_err


def _median_ms(fn, torch) -> float:
    for _ in range(10):
        fn()
    times = []
    for _ in range(50):
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


def time_kernel(ppm_pool, torch, card: str) -> dict:
    out = {}
    v = torch.tensor(VALID_CHECKS[0][1], dtype=torch.int32, device="cuda")
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        x = torch.randn(MAIN_SHAPE, device="cuda").to(dtype)
        k_ms = _median_ms(lambda: ppm_pool.pyramid_pool(x), torch)
        p_ms = _median_ms(lambda: ppm_pool.pyramid_pool_plain(x), torch)
        out[("dense", dt)] = (k_ms, p_ms)
        print(f"[time] pyramid_pool {MAIN_SHAPE} {dt}: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms (median of 50; card: {card})", flush=True)
        xv = torch.randn(VALID_SHAPE, device="cuda").to(dtype)
        k_ms = _median_ms(lambda: ppm_pool.pyramid_pool(xv, valid_hw=v), torch)
        p_ms = _median_ms(lambda: ppm_pool.pyramid_pool_plain(xv, valid_hw=v), torch)
        out[("valid", dt)] = (k_ms, p_ms)
        print(f"[time] pyramid_pool valid_hw {VALID_SHAPE} {dt}: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms (median of 50; card: {card})", flush=True)
    return out


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


def _cfg(*opts):
    from semseg_tpu.config import cfg as default_cfg

    cfg = default_cfg.clone()
    cfg.merge_from_file(CFG)
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg


def _val_items(cfg, val_dir, odgt):
    """(pyramids, labels) of a val set as the default eval CLI loads them."""
    from semseg_tpu.data import ValDataset

    ds = ValDataset(val_dir, odgt, cfg.DATASET, device_preprocess=True,
                    bucket_step=cfg.TPU.eval_bucket_step)
    items = [ds[i] for i in range(len(ds))]
    return [it["img_data"] for it in items], [it["seg_label"][0] for it in items]


def expected_chunks(cfg, val_dir, odgt):
    """Chunks the batched engine schedules for the val set (one call of
    <= 32 images), counted from its own schedule."""
    from semseg_tpu_torch.engine import BatchedInferenceEngine

    pyrs, labels = _val_items(cfg, val_dir, odgt)
    eng = BatchedInferenceEngine(None, device="cpu", batch_size=4, pack_buckets=True,
                                 bucket_step=cfg.TPU.eval_bucket_step)
    windows = eng._canvas_windows([lab.shape for lab in labels], range(len(pyrs)))
    chunks = 0
    for window in windows:
        groups = eng._group_by_bucket([pyrs[i] if i in window else [] for i in range(len(pyrs))])
        fill = sorted((k, len(t), len({x[0] for x in t})) for k, t in groups.items())
        folded = sum(eng._bucket_key(h, w) != k for k, t in groups.items() for *_, h, w in t)
        print(f"[main] window of {len(window)} images: buckets (key, tasks, images) {fill}; "
              f"{folded} tasks packed into a larger bucket", flush=True)
        shared = [f for f in fill if f[2] > 1]
        padded = [f for f in fill if f[1] % 4]
        if not shared or not padded:
            raise RuntimeError("the eval images must share a bucket and pad a last chunk")
        chunks += len(eng._schedule(groups))
    return chunks


def _run_path(name, fn, ppm_pool, torch):
    """Drive one path with both launch counts set to 0; returns (result,
    seconds, dense launches, valid launches)."""
    torch.cuda.synchronize()
    ppm_pool.LAUNCHES = 0
    ppm_pool.VALID_LAUNCHES = 0
    tic = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - tic
    dense, valid = ppm_pool.LAUNCHES, ppm_pool.VALID_LAUNCHES
    print(f"[main] {name}: pyramid_pool launches dense {dense}, valid_hw {valid}", flush=True)
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
            print(f"[main] {name}: {valid} valid_hw launches = {chunks} chunks scheduled "
                  f"(batch 4, packed)", flush=True)
        print(f"[main] {name}: mIoU {miou:.4f}, accuracy {acc * 100:.2f}% (random weights), "
              f"{wall_s / len(EVAL_IMAGES):.4f} s/image wall (first run, model build and "
              f"cuDNN set-up included), {raw['seconds_per_image']:.4f} s/image in the engine",
              flush=True)
    exact, batched = results["cli.eval --exact"], results["cli.eval"]
    if exact["pix_count"] != batched["pix_count"]:
        raise RuntimeError("the two eval paths counted different labelled pixels")
    return ckpt, val_dir, odgt, launches


def steady_state(ckpt, val_dir, odgt, torch, card):
    """Seconds per image of the batched and exact engines once cuDNN has
    seen the shapes, and a profile of one batched pass."""
    from semseg_tpu.data import ValDataset
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

    def run_batched():
        batched.batched_metrics(pyrs, labels)

    def run_exact():
        for pyr, lab in zip(host_pyrs, labels):
            exact.predict(pyr, lab.shape)

    times = {}
    for name, fn in (("batched", run_batched), ("exact", run_exact)):
        fn()  # warm-up
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - tic) / len(pyrs))
        times[name] = sorted(runs)[1]
        print(f"[steady] {name} engine: {times[name]:.4f} s/image (median of 3 passes over "
              f"{len(pyrs)} images, 5 scales, bf16; card: {card})", flush=True)
    busy_ms = profile_batched(run_batched, torch, card)
    if busy_ms:
        wall_ms = times["batched"] * len(pyrs) * 1e3
        print(f"[profile] batched pass without the profiler: {wall_ms:.1f} ms wall, so device "
              f"idle share about {max(0.0, 1 - busy_ms / wall_ms):.3f}", flush=True)
    return times


def profile_batched(fn, torch, card):
    """Device busy share, the top kernels and the top operators (by the
    device time of the kernels they launch) of one batched pass."""
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
    with open(os.path.join(OUT_DIR, "chip_smoke_profile.txt"), "w") as f:
        f.write(f"card: {card}\n")
        f.write(events.table(sort_by="self_device_time_total", row_limit=80, max_name_column_width=120))

    def dev_ms(e):
        return e.self_device_time_total / 1e3

    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    ops = [e for e in events if e.device_type == DeviceType.CPU and e.key.startswith("aten::")]
    busy_ms = sum(dev_ms(e) for e in kernels)
    if busy_ms <= 0:
        print("[profile] batched pass: the profiler recorded no device time; "
              "device busy share not measured", flush=True)
        return
    print(f"[profile] batched pass under torch.profiler: wall {wall_ms:.1f} ms, device "
          f"kernel time {busy_ms:.1f} ms, busy share {busy_ms / wall_ms:.3f} (card: {card})",
          flush=True)
    for title, rows in (("kernels", kernels), ("operators", ops)):
        for e in sorted(rows, key=dev_ms, reverse=True)[:10]:
            print(f"[profile] {title}: {dev_ms(e):8.3f} ms {dev_ms(e) / busy_ms:6.1%} "
                  f"{e.count:5d} calls  {e.key[:100]}", flush=True)
    return busy_ms


def card_vs_cpu(ckpt, torch):
    import numpy as np

    from semseg_tpu.data.dataset import PyramidBuilder
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

    from semseg_tpu.utils import accuracy, intersectionAndUnion
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


def main() -> int:
    import torch

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

    tic = time.perf_counter()
    ppm_pool._lib()
    print(f"[build] ppm_pool.cu built/loaded in {time.perf_counter() - tic:.2f} s", flush=True)

    max_err = check_kernel(ppm_pool, torch)
    valid_err = check_valid_kernel(ppm_pool, torch)
    times = time_kernel(ppm_pool, torch, card)

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as work:
        ckpt, val_dir, odgt, launches = main_path(work, torch, ppm_pool)
        steady_state(ckpt, val_dir, odgt, torch, card)
        card_vs_cpu(ckpt, torch)
        batched_f32(ckpt, work, torch)

    entry = dict(route="cuda", source="semseg_tpu_torch/csrc/ppm_pool.cu")
    print(json.dumps({"kernels": [
        {"name": "pyramid_pool", **entry, "replaces": "semseg_tpu/ops/pallas/ppm_pool.py:40",
         "launches": launches["dense"], "max_abs_err": max_err,
         "ms": times[("dense", "bfloat16")][0], "plain_ms": times[("dense", "bfloat16")][1]},
        {"name": "pyramid_pool_valid", **entry,
         "replaces": "semseg_tpu/ops/resize_dynamic.py:70",
         "launches": launches["valid"], "max_abs_err": valid_err,
         "ms": times[("valid", "bfloat16")][0], "plain_ms": times[("valid", "bfloat16")][1]},
    ]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
