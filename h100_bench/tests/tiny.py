"""Tiny cells for the CPU tests: the benchmark's own cells with the
image sizes, chunks and batches cut so that a run takes seconds on the
CPU, optionally with the program in float64."""

from __future__ import annotations

import copy

from h100_bench import harness

SHAPES = [(48, 64), (64, 48), (40, 56), (56, 40), (72, 96), (50, 60), (60, 44), (66, 50)]


def tiny(name: str, float64: bool = False) -> harness.Cell:
    cell = copy.deepcopy(harness.load_cell(name))
    ds = cell.config["cfg"]["DATASET"]
    ds["imgSizes"], ds["imgMaxSize"] = [32, 40], 64
    t = cell.traffic
    t["shapes"] = [list(s) for s in SHAPES]  # manifest shapes small enough for the CPU
    if cell.driver == "eval_ms":
        t.update(chunk=3, chunks=2, batch=2, checked_images=3, image_grid=8, label_grid=8,
                 bn_batch=[4, 48, 64])
    else:
        ds["imgSizes"] = [32]
        t.update(batch_per_gpu=2 if cell.chips == 1 else 1, portrait=1, landscape=2,
                 image_grid=8, label_grid=8, disp_iter=2)
    if float64:
        cell.config["cfg"]["TPU"]["compute_dtype"] = "float64"
    return cell
