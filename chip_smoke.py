#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``semseg_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA. In order:

1. device: the card's name and power limit;
2. build: the CUDA kernels from ``semseg_tpu_torch/csrc`` (nvcc, sm_90a);
3. each kernel against its plain PyTorch version at the main path's shapes;
4. kernel and plain times (CUDA events, 10 warm-up runs, median of 50);
5. the main path at full width: the flagship resnet50dilated + ppm_deepsup
   with seeded random weights saved as a reference ``.pth`` pair, through
   ``cli.test`` (3 images) and ``cli.eval --exact`` (2 labelled images) over
   all 5 scales, with the kernel's launch count checked against
   images x scales;
6. float32 card against CPU on a 2-scale pyramid (TF32 off).

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
MAIN_SHAPE = (1, 75, 100, 2048)  # conv5 of a 600-px level
CHECK_SHAPES = [
    ((1, 75, 100, 2048), "float32"), ((1, 75, 100, 2048), "bfloat16"),
    ((1, 38, 50, 2048), "float32"), ((1, 38, 50, 2048), "bfloat16"),
    ((2, 13, 17, 256), "float32"), ((1, 1, 1, 2048), "bfloat16"),
    ((1, 75, 100, 720), "bfloat16"),
]
TEST_IMAGES = [(480, 640), (375, 500), (600, 451)]  # (H, W)
EVAL_IMAGES = [(375, 500), (512, 384)]


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
    for dt in ("bfloat16", "float32"):
        x = torch.randn(MAIN_SHAPE, device="cuda").to(getattr(torch, dt))
        k_ms = _median_ms(lambda: ppm_pool.pyramid_pool(x), torch)
        p_ms = _median_ms(lambda: ppm_pool.pyramid_pool_plain(x), torch)
        out[dt] = (k_ms, p_ms)
        print(f"[time] pyramid_pool {MAIN_SHAPE} {dt}: kernel {k_ms:.4f} ms, "
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


def main_path(work, torch, ppm_pool):
    import numpy as np

    from semseg_tpu.config import cfg as default_cfg
    from semseg_tpu_torch.cli import eval as eval_cli, test as test_cli
    from semseg_tpu_torch.models import ModelBuilder

    cfg = default_cfg.clone()
    cfg.merge_from_file(CFG)
    n_scales = len(cfg.DATASET.imgSizes)
    ckpt = os.path.join(work, "ckpt")
    os.makedirs(ckpt)
    model = ModelBuilder.build_model(cfg, device="cpu", seed=0)
    for name, module in (("encoder", model.encoder), ("decoder", model.decoder)):
        torch.save(module.state_dict(), os.path.join(ckpt, f"{name}_epoch_20.pth"))
    del model

    rng = np.random.RandomState(0)
    test_dir = os.path.join(work, "test_imgs")
    val_dir = os.path.join(work, "val")
    out_dir = os.path.join(work, "result")
    os.makedirs(test_dir)
    os.makedirs(val_dir)
    _write_images(test_dir, TEST_IMAGES, rng)
    records = _write_images(val_dir, EVAL_IMAGES, rng, labels=True)
    odgt = os.path.join(val_dir, "val.odgt")
    with open(odgt, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in records)

    torch.cuda.synchronize()
    ppm_pool.LAUNCHES = 0
    tic = time.perf_counter()
    test_cli.main(["--imgs", test_dir, "--cfg", CFG, "DIR", ckpt, "TEST.result", out_dir])
    torch.cuda.synchronize()
    test_s = time.perf_counter() - tic
    tic = time.perf_counter()
    miou, acc, _, raw = eval_cli.main([
        "--cfg", CFG, "--exact", "DIR", ckpt, "DATASET.root_dataset", val_dir,
        "DATASET.list_val", odgt,
    ])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - tic
    launches = ppm_pool.LAUNCHES

    pngs = sorted(p for p in os.listdir(out_dir) if p.endswith(".png"))
    if len(pngs) != len(TEST_IMAGES):
        raise RuntimeError(f"test CLI wrote {pngs}, expected {len(TEST_IMAGES)} PNGs")
    expected = (len(TEST_IMAGES) + len(EVAL_IMAGES)) * n_scales
    if launches != expected:
        raise RuntimeError(f"pyramid_pool launched {launches} times, expected {expected}")
    if not (np.isfinite(miou) and 0.0 <= miou <= 1.0 and 0.0 <= acc <= 1.0):
        raise RuntimeError(f"eval metrics out of range: mIoU {miou}, acc {acc}")
    print(f"[main] test CLI: {len(pngs)} PNGs, {test_s / len(TEST_IMAGES):.3f} s/image "
          f"wall (first run, cuDNN set-up included)", flush=True)
    print(f"[main] eval --exact: mIoU {miou:.4f}, accuracy {acc * 100:.2f}% "
          f"(random weights), {eval_s / len(EVAL_IMAGES):.3f} s/image wall, "
          f"{raw['seconds_per_image']:.3f} s/image in the engine", flush=True)
    print(f"[main] pyramid_pool launches: {launches} = {len(TEST_IMAGES) + len(EVAL_IMAGES)} "
          f"images x {n_scales} scales", flush=True)
    return ckpt, launches, raw["seconds_per_image"]


def steady_state(ckpt, torch):
    """Seconds per image of the exact engine once cuDNN has seen the shapes."""
    import numpy as np

    from semseg_tpu.config import cfg as default_cfg
    from semseg_tpu.data.dataset import PyramidBuilder
    from semseg_tpu_torch.cli.eval import build_engine
    from semseg_tpu_torch.checkpoint import resolve_reference_checkpoint

    cfg = default_cfg.clone()
    cfg.merge_from_file(CFG)
    cfg.DIR = ckpt
    resolve_reference_checkpoint(cfg, cfg.TEST.checkpoint)
    engine = build_engine(cfg, "cuda")
    builder = PyramidBuilder(cfg.DATASET)
    rng = np.random.RandomState(1)
    items = [(builder.multi_scale_pyramid(rng.randint(0, 256, (h, w, 3), np.uint8)), (h, w))
             for h, w in TEST_IMAGES]
    for pyr, hw in items:  # warm-up
        engine.predict(pyr, hw)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for pyr, hw in items:
        engine.predict(pyr, hw)
    torch.cuda.synchronize()
    s = (time.perf_counter() - tic) / len(items)
    print(f"[main] exact engine steady state: {s:.4f} s/image (5 scales, bf16, "
          f"images {TEST_IMAGES})", flush=True)
    return s


def card_vs_cpu(ckpt, torch):
    import numpy as np

    from semseg_tpu.config import cfg as default_cfg
    from semseg_tpu.data.dataset import PyramidBuilder
    from semseg_tpu_torch.cli.eval import build_engine
    from semseg_tpu_torch.checkpoint import resolve_reference_checkpoint

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[f32] TF32 off for cuDNN convolutions and matmuls", flush=True)
    cfg = default_cfg.clone()
    cfg.merge_from_file(CFG)
    cfg.merge_from_list(["DIR", ckpt, "DATASET.imgSizes", "(300, 375)"])
    resolve_reference_checkpoint(cfg, cfg.TEST.checkpoint)
    h, w = 375, 500
    img = np.random.RandomState(2).randint(0, 256, (h, w, 3), np.uint8)
    pyramid = PyramidBuilder(cfg.DATASET).multi_scale_pyramid(img)

    cfg.TPU.compute_dtype = "float32"
    card = build_engine(cfg, "cuda").scores_for_pyramid(pyramid, (h, w))
    cpu = build_engine(cfg, "cpu").scores_for_pyramid(pyramid, (h, w))
    err = float(np.abs(card - cpu).max())
    agree = float((card.argmax(-1) == cpu.argmax(-1)).mean())
    print(f"[f32] card vs CPU: max |dp| {err:.3e}, argmax agreement {agree:.6f}", flush=True)
    if not (np.isfinite(card).all() and err <= 1e-3 and agree > 0.999):
        raise RuntimeError("float32 card output disagrees with the CPU")

    cfg.TPU.compute_dtype = "bfloat16"
    bf16 = build_engine(cfg, "cuda").scores_for_pyramid(pyramid, (h, w))
    print(f"[bf16] bf16 vs f32 on the card (no threshold): max |dp| "
          f"{float(np.abs(bf16 - card).max()):.3e}, argmax agreement "
          f"{float((bf16.argmax(-1) == card.argmax(-1)).mean()):.6f}", flush=True)


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
    times = time_kernel(ppm_pool, torch, card)

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as work:
        ckpt, launches, _ = main_path(work, torch, ppm_pool)
        steady_state(ckpt, torch)
        card_vs_cpu(ckpt, torch)

    k_ms, p_ms = times["bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "pyramid_pool", "route": "cuda",
        "source": "semseg_tpu_torch/csrc/ppm_pool.cu",
        "replaces": "semseg_tpu/ops/pallas/ppm_pool.py:40",
        "launches": launches, "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
    }]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
