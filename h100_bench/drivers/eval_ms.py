"""Driver ``eval_ms``: the multi-scale evaluation protocol as ``cli.eval
--device-pyramid`` runs it.

The entry is ``DevicePyramidEngine.batched_metrics_from_originals``, built
by ``cli.eval.build_engines`` at the traffic's batch with packed buckets,
called on chunks of ``chunk`` originals (``cli.eval``'s ``CHUNK``) with their
label maps; each call returns every image's packed counts (correct and
labelled pixels, per-class intersection and union).

Set-up: the engine, the seed's weights loaded into it, the seed's chunks,
one call of each chunk (every shape of the window). The window cycles over
the chunks in whole cycles until ``seconds`` have passed: ``eval_img_per_s``
is the images whose counts came back over the window's time. The traced
run then profiles one more call of the first chunk; its shares of time
read the window's calls of that chunk, and its FLOPs the whole window's.

``correct``: a sample of the images drawn from the seed is labelled in
set-up by the plain float32 reference: its argmax on its clearest pixels,
void elsewhere (a random network's argmax ties often, and there a rounding
decides; ``label_checked``). After the window, every answer the window
returned for those images is held against the reference's counts on the
same original and labels: the gap in counts over the labelled pixels
(``count_gap``) and the labelled pixels themselves (``pix_gap``, exact).
The labelling's time is not counted in ``setup_s``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np

from h100_bench import data, frozen, harness, trace
from h100_bench.reference.model import Arch, forward_flops


def arch_of(config: dict) -> Arch:
    m = config["cfg"]["MODEL"]
    return Arch(m["arch_encoder"], m["arch_decoder"], m["fc_dim"],
                config["cfg"]["DATASET"]["num_class"])


def reference_dtype(config: dict):
    """The reference's arithmetic: float64 for a float64 program, else
    float32 (with TF32 off)."""
    import torch

    return torch.float64 if config["cfg"]["TPU"]["compute_dtype"] == "float64" else torch.float32


def protocol(config: dict) -> dict:
    """The evaluation protocol's settings of a configuration."""
    ds, tpu = config["cfg"]["DATASET"], config["cfg"]["TPU"]
    return dict(img_sizes=tuple(ds["imgSizes"]), max_size=ds["imgMaxSize"],
                lattice=frozen.effective_lattice(tpu["eval_bucket_step"], ds["padding_constant"]),
                num_class=ds["num_class"])


def level_canvases(shapes, config: dict, traffic: dict) -> Dict[int, List[Tuple[int, ...]]]:
    """Per image of a chunk, its levels as (th, tw, canvas_h, canvas_w), the
    canvas being the bucket the engine's packing puts the level in."""
    p = protocol(config)
    out: Dict[int, list] = {}
    for key, tasks, _ in frozen.eval_schedule(shapes, p["img_sizes"], p["max_size"],
                                              p["lattice"], p["num_class"], traffic["batch"],
                                              traffic["pack_buckets"]):
        for i, th, tw in tasks:
            out.setdefault(i, []).append((th, tw, key[0], key[1]))
    return out


def chunk_counts(config: dict, traffic: dict, shapes, flops_cache: dict) -> dict:
    """What one call over originals of ``shapes`` does usefully: images,
    forward FLOPs of the levels at their own sizes (no padding, no repeated
    slot), and the pool's bytes over the real slots' conv5 extents."""
    arch = arch_of(config)
    p = protocol(config)
    elsize = 2 if config["cfg"]["TPU"]["compute_dtype"] == "bfloat16" else 4
    flops = 0
    pool_bytes = 0
    for h, w in shapes:
        for th, tw in frozen.level_plan(h, w, p["img_sizes"], p["max_size"], p["lattice"]):
            if (th, tw) not in flops_cache:
                flops_cache[(th, tw)] = forward_flops(arch, (1, 3, th, tw))
            flops += flops_cache[(th, tw)]
    os_ = arch.output_stride
    for _, tasks, _ in frozen.eval_schedule(shapes, p["img_sizes"], p["max_size"], p["lattice"],
                                            p["num_class"], traffic["batch"],
                                            traffic["pack_buckets"]):
        extents = [(-(-th // os_), -(-tw // os_)) for _, th, tw in tasks]
        pool_bytes += frozen.pool_forward_bytes(extents, arch.fc_dim, elsize)
    return {"kind": "eval", "images": len(shapes), "flops": flops, "pool_fwd_bytes": pool_bytes}


def weights(cell: harness.Cell, seed: int, device: str) -> dict:
    """The seed's weights of the cell, made on ``device``: seeded, with BN
    statistics of a seeded batch (``reference.model.eval_params``)."""
    import torch

    from h100_bench.reference.model import eval_params

    dev = torch.device(device)
    return eval_params(arch_of(cell.config), seed, dev, data.bn_images(cell.traffic, seed, dev))


def build(cell: harness.Cell, seed: int, device: str):
    """The engine with the seed's weights, and the seed's chunks."""
    import torch
    from semseg_tpu_torch.cli.eval import build_engines

    cfg = harness.port_cfg(cell.config)
    tr = cell.traffic
    engine = build_engines(cfg, 1, batch=tr["batch"], fetch_dtype="bfloat16",
                           pack_buckets=tr["pack_buckets"], device_pyramid=True,
                           device=device)[0]
    engine.model.load_state_dict(weights(cell, seed, device))
    chunks = data.eval_chunks(tr, seed, cfg.DATASET.num_class, torch.device(device))
    return engine, chunks


def checked(seed: int, traffic: dict) -> List[Tuple[int, int]]:
    """The images whose answers are checked, drawn from the seed: (chunk
    position in the seed's order, image index)."""
    n, k = traffic["chunk"], traffic["chunks"]
    rng = np.random.RandomState((seed * 7 + 3) % (1 << 32))
    flat = rng.choice(n * k, min(traffic["checked_images"], n * k), replace=False)
    return sorted((int(f) // n, int(f) % n) for f in flat)


def reference_model(cell: harness.Cell, seed: int, device: str, low: str = None):
    """The plain reference of the cell's configuration with the seed's
    weights; with ``low`` its storage in that precision
    (``reference.model.Numerics``)."""
    from h100_bench.reference.model import Model, Numerics

    return Model(weights(cell, seed, device), arch_of(cell.config),
                 Numerics(reference_dtype(cell.config), low))


def _levels(cell: harness.Cell, seed: int, k: int, i: int):
    shapes = data.eval_shapes(cell.traffic)
    order = np.random.RandomState(seed % (1 << 32)).permutation(len(shapes))
    return level_canvases(shapes[order[k]], cell.config, cell.traffic)[i]


def label_checked(cell: harness.Cell, seed: int, chunks, chosen, device: str) -> None:
    """The chosen images' labels replaced, in place, by the plain float32
    reference's argmax on its ``confident_share`` of clearest pixels, void
    elsewhere (``reference.evaluate.confident_labels``): so that the counts
    check the pixels whose class no rounding decides."""
    import torch

    from h100_bench.reference.evaluate import confident_labels, image_scores

    model = reference_model(cell, seed, device)
    with no_tf32():
        for k, i in chosen:
            oris, labs = chunks[k]
            scores = image_scores(model, torch.as_tensor(oris[i], device=torch.device(device)),
                                  labs[i].shape, _levels(cell, seed, k, i))
            labs[i] = confident_labels(scores, cell.traffic["confident_share"]).cpu().numpy()


def reference_counts(cell: harness.Cell, seed: int, chunks, chosen, device: str,
                     low: str = None) -> List[np.ndarray]:
    """The plain reference's counts of the chosen images (``chosen``: (chunk
    position, image index)) against their labels, one image at a time with
    TF32 off; with ``low`` its storage in that precision."""
    import torch

    from h100_bench.reference.evaluate import image_counts

    dev = torch.device(device)
    model = reference_model(cell, seed, device, low)
    with no_tf32():
        return [image_counts(model, torch.as_tensor(chunks[k][0][i], device=dev),
                             torch.as_tensor(chunks[k][1][i], device=dev),
                             _levels(cell, seed, k, i)) for k, i in chosen]


class no_tf32:
    """float32 products and convolutions in float32, not TF32."""

    def __enter__(self):
        import torch

        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def gaps(program: np.ndarray, reference: np.ndarray) -> Tuple[float, float]:
    """(count gap, labelled-pixel gap) of one image's counts: the counts'
    absolute differences over its labelled pixels, and the difference of
    the labelled pixels themselves."""
    pix = max(reference[1], 1.0)
    diff = np.abs(np.asarray(program, np.float64) - reference)
    return float((diff[0] + diff[2:].sum()) / pix), float(diff[1])


def answer(result) -> np.ndarray:
    """One image's packed counts as the entry returns them, as a vector."""
    return np.array([result[0], result[1], *result[2], *result[3]], np.float64)


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
        t0: float = None) -> dict:
    import torch

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t0 = time.perf_counter() if t0 is None else t0
    phases = {"start": time.perf_counter() - t0}
    engine, chunks = build(cell, seed, device)
    sync()
    phases["engine, weights, data"] = time.perf_counter() - t0 - sum(phases.values())
    chosen = checked(seed, cell.traffic)
    label_checked(cell, seed, chunks, chosen, device)
    if on_card:
        torch.cuda.empty_cache()
    sync()
    # The benchmark's own labelling, not the program's set-up.
    labelling = phases["labels (the reference's; not set-up)"] = (
        time.perf_counter() - t0 - sum(phases.values()))
    for oris, labs in chunks:  # every shape of the window
        engine.batched_metrics_from_originals(oris, labs)
    sync()
    phases["warm-up"] = time.perf_counter() - t0 - sum(phases.values())
    setup_s = time.perf_counter() - t0 - labelling

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    answers, calls, k_n, ends = [], 0, len(chunks), []
    start = time.perf_counter()
    while True:
        answers.append(engine.batched_metrics_from_originals(*chunks[calls % k_n]))
        ends.append(time.perf_counter() - start)  # the call's counts are on the host
        calls += 1
        if calls % k_n == 0 and ends[-1] >= seconds:
            break
    elapsed = time.perf_counter() - start
    images = calls * cell.traffic["chunk"]
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    took = [b - a for a, b in zip([0.0] + ends, ends)]
    cycles = [sum(took[c:c + k_n]) for c in range(0, calls, k_n)]
    by_chunk = [float(np.mean(took[k::k_n])) for k in range(k_n)]
    notes = [f"window: {calls // k_n} cycles in {elapsed!r} s; each cycle: "
             f"{', '.join(f'{t:.4f}' for t in cycles)} s; each chunk's mean call: "
             f"{', '.join(f'{t:.4f}' for t in by_chunk)} s"]

    window = None
    if traced and on_card:
        shapes = data.eval_shapes(cell.traffic)
        order = np.random.RandomState(seed % (1 << 32)).permutation(len(shapes))
        cache: dict = {}
        counts = [chunk_counts(cell.config, cell.traffic, shapes[k], cache) for k in order]
        window_flops = sum(counts[c % k_n]["flops"] for c in range(calls))

        def stretch():
            engine.batched_metrics_from_originals(*chunks[0])
            return dict(counts[0], paced_s=by_chunk[0], window_flops=window_flops,
                        window_s=elapsed)

        window = trace.profiled(stretch, harness.CACHE)
        notes.append(f"traced call: {window.traced_s!r} s, the card busy {window.busy_s!r} s; "
                     f"the untraced window's calls of that chunk: {by_chunk[0]!r} s")

    del engine
    if on_card:
        torch.cuda.empty_cache()
    ref = dict(zip(chosen, reference_counts(cell, seed, chunks, chosen, device)))
    # Every answer of a checked image that the window returned.
    g = [gaps(answer(answers[c][i]), ref[(k, i)])
         for c in range(calls) for k, i in chosen if k == c % k_n]
    limits = cell.traffic["limits"]
    checks = [harness.Check("count_gap", max(x for x, _ in g), limits["count_gap"]),
              harness.Check("pix_gap", max(y for _, y in g), limits["pix_gap"])]
    failed = sum(1 for x, y in g if x > limits["count_gap"] or y > limits["pix_gap"])
    return {
        "attempted": images, "failed": failed,
        "metrics": {"eval_img_per_s": images / elapsed, "setup_s": setup_s},
        "memory_peak_bytes": peak, "window": window, "checks": checks,
        "readings": g, "phases": phases, "notes": notes,
    }
