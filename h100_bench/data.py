"""The benchmark's inputs, made from ``--seed``.

Every seed gets the same set of sizes (drawn once with the traffic file's
``draw_seed`` from a frozen manifest), so that a run's work does not depend
on its seed; the seed orders them and makes the pixels and labels. Images
are smooth random fields (a coarse random grid upsampled bilinearly, plus a
little noise), labels coarse random class maps upsampled by nearest
neighbour with a share of void, both made on the device in bulk.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import frozen


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def image(gen, h: int, w: int, grid: int, device) -> torch.Tensor:
    """(h, w, 3) uint8 smooth random image."""
    coarse = torch.rand((1, 3, max(h // grid, 2), max(w // grid, 2)), generator=gen,
                        device=device) * 255.0
    x = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    x = x + torch.randn((1, 3, h, w), generator=gen, device=device) * 8.0
    return x.clamp(0, 255).round().to(torch.uint8)[0].permute(1, 2, 0)


def labels(gen, h: int, w: int, grid: int, num_class: int, void_share: float,
           device) -> torch.Tensor:
    """(h, w) int32 class map in [-1, num_class): coarse cells of one class
    each, ``void_share`` of them void (-1)."""
    ch, cw = max(h // grid, 1), max(w // grid, 1)
    cls = torch.randint(0, num_class, (1, 1, ch, cw), generator=gen, device=device)
    void = torch.rand((1, 1, ch, cw), generator=gen, device=device) < void_share
    cls = torch.where(void, -1, cls).to(torch.float32)
    return F.interpolate(cls, size=(h, w), mode="nearest")[0, 0].to(torch.int32)


# -- evaluation ---------------------------------------------------------------
def bn_images(traffic: dict, seed: int, device) -> torch.Tensor:
    """The images whose batch statistics become the eval weights' BN
    running statistics (``reference.model.eval_params``): ``bn_batch`` =
    (N, H, W) smooth random images like the cell's, normalised, NCHW."""
    n, h, w = traffic["bn_batch"]
    gen = generator(seed + 1, device)
    x = torch.stack([image(gen, h, w, traffic["image_grid"], device) for _ in range(n)])
    mean = torch.tensor([0.485, 0.456, 0.406], device=device)
    std = torch.tensor([0.229, 0.224, 0.225], device=device)
    return ((x.to(torch.float32) / 255.0 - mean) / std).permute(0, 3, 1, 2)



def eval_shapes(traffic: dict, canvas=(1088, 1600)) -> List[List[Tuple[int, int]]]:
    """The cell's chunks of original shapes, the same for every seed:
    ``chunks`` x ``chunk`` shapes drawn with ``draw_seed`` from the
    manifest's originals that fit the device-pyramid engine's canvas."""
    shapes = [s for s in frozen.read_shapes(traffic["shapes"])
              if s[0] <= canvas[0] and s[1] <= canvas[1]]
    n, k = traffic["chunk"], traffic["chunks"]
    drawn = frozen.sample_odgt_shapes(shapes, n * k, traffic["draw_seed"])
    return [drawn[i * n:(i + 1) * n] for i in range(k)]


def eval_chunks(traffic: dict, seed: int, num_class: int, device):
    """Per chunk, in the seed's order: (originals, labels), lists of
    (H, W, 3) uint8 and (H, W) int32 numpy arrays."""
    chunks = eval_shapes(traffic)
    order = np.random.RandomState(seed % (1 << 32)).permutation(len(chunks))
    gen = generator(seed, device)
    out = []
    for k in order:
        imgs = [image(gen, h, w, traffic["image_grid"], device) for h, w in chunks[k]]
        labs = [labels(gen, h, w, traffic["label_grid"], num_class, traffic["void_share"],
                       device) for h, w in chunks[k]]
        out.append(([t.cpu().numpy() for t in imgs], [t.cpu().numpy() for t in labs]))
    return out


# -- training -----------------------------------------------------------------
def train_plan(traffic: dict, config: dict) -> List[dict]:
    """The cell's training batches as sizes, the same for every seed: for
    each short side of ``imgSizes``, ``portrait`` batches of portrait and
    ``landscape`` of landscape originals, each ``batch_per_gpu`` x ranks
    manifest shapes of its aspect bin (drawn with ``draw_seed``) sized by
    ``TrainDataset.next_batch``'s rules. Each batch:
    ``{"short": s, "canvas": (H, W), "sizes": [(h, w), ...]}``."""
    ds, tpu = config["cfg"]["DATASET"], config["cfg"]["TPU"]
    lattice = frozen.effective_lattice(max(tpu["bucket_step"], ds["padding_constant"]),
                                       ds["padding_constant"])
    shapes = frozen.read_shapes(traffic["shapes"])
    bins = ([s for s in shapes if frozen.aspect_bin(s) == 0],
            [s for s in shapes if frozen.aspect_bin(s) == 1])
    rng = np.random.RandomState(traffic["draw_seed"])
    n = traffic["batch_per_gpu"] * traffic.get("ranks", 1)
    plan = []
    for short in ds["imgSizes"]:
        for b, count in ((0, traffic["portrait"]), (1, traffic["landscape"])):
            for _ in range(count):
                drawn = [bins[b][i] for i in rng.choice(len(bins[b]), n, replace=False)]
                canvas, sizes = frozen.train_canvas(drawn, short, ds["imgMaxSize"], lattice)
                plan.append({"short": short, "canvas": canvas, "sizes": sizes})
    return plan


def train_batches(traffic: dict, config: dict, seed: int, device, rank=None) -> List[Dict]:
    """The host batches of the cell in the seed's order, as
    ``TrainDataset.next_batch(raw_transport=True)`` gives them: ``img_data``
    (N, H, W, 3) uint8 zero beyond each image, ``img_valid_hw`` (N, 2)
    int32, ``seg_label`` (N, H / rate, W / rate) int32, -1 beyond each
    image's ceil-rounded label block. With ``rank`` (a data-parallel run),
    the rank's rows [rank * N, (rank + 1) * N) of each global batch on the
    rank's own canvas (its images' maximum on the lattice), which the
    program's canvas exchange pads to the ranks' maximum; without, each
    global batch whole."""
    plan = train_plan(traffic, config)
    order = np.random.RandomState(seed % (1 << 32)).permutation(len(plan))
    ds, tpu = config["cfg"]["DATASET"], config["cfg"]["TPU"]
    lattice = frozen.effective_lattice(max(tpu["bucket_step"], ds["padding_constant"]),
                                       ds["padding_constant"])
    rate, ncls = ds["segm_downsampling_rate"], ds["num_class"]
    per = traffic["batch_per_gpu"]
    gen = generator(seed, device)
    out = []
    for k in order:
        (ch, cw), sizes = plan[k]["canvas"], plan[k]["sizes"]
        img = torch.zeros((len(sizes), ch, cw, 3), dtype=torch.uint8, device=device)
        lab = torch.full((len(sizes), ch // rate, cw // rate), -1, dtype=torch.int32,
                         device=device)
        for i, (h, w) in enumerate(sizes):
            img[i, :h, :w] = image(gen, h, w, traffic["image_grid"], device)
            lh, lw = -(-h // rate), -(-w // rate)
            lab[i, :lh, :lw] = labels(gen, lh, lw, max(traffic["label_grid"] // rate, 1), ncls,
                                      traffic["void_share"], device)
        if rank is not None:
            rows = slice(rank * per, (rank + 1) * per)
            sizes = sizes[rows]
            oh = int(frozen.round_up(max(h for h, _ in sizes), lattice))
            ow = int(frozen.round_up(max(w for _, w in sizes), lattice))
            img, lab = img[rows, :oh, :ow], lab[rows, :oh // rate, :ow // rate]
        out.append({"img_data": img.cpu().numpy(), "seg_label": lab.cpu().numpy(),
                    "img_valid_hw": np.asarray(sizes, np.int32)})
    return out
