"""Rank-side programs of the port's data-parallel tests
(``test_torch_dist_*.py``). ``spawn`` runs one of them on gloo ranks on the
CPU, in processes started with ``torch.multiprocessing.spawn``; this module
imports PyTorch and the port only, so a rank loads no JAX. Each rank writes
what it computed to ``<out>/rank<r>.pt`` for the test to hold against the
JAX package. No tests here.
"""

import os

import numpy as np
import torch


def start(fn, world, *args):
    """Starts ``fn(rank, *args)`` on ``world`` gloo ranks on the CPU;
    returns a function that waits for them (and raises a rank's error)."""
    from semseg_tpu_torch.parallel import distributed

    ctx = torch.multiprocessing.spawn(_entry, args=(fn, world, distributed.free_port(), args),
                                      nprocs=world, join=False)

    def join():
        while not ctx.join():
            pass

    return join


def spawn(fn, world, *args):
    """``fn(rank, *args)`` on ``world`` gloo ranks on the CPU, to the end."""
    start(fn, world, *args)()


def _entry(rank, fn, world, port, args):
    from semseg_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu", timeout=120)
    try:
        fn(rank, *args)
    finally:
        distributed.shutdown()


def load(out, world=2):
    """The ranks' results; their files (a float64 state is ~200 MB) are
    removed once read."""
    results = []
    for r in range(world):
        path = os.path.join(out, f"rank{r}.pt")
        results.append(torch.load(path, weights_only=False))
        os.remove(path)
    return results


def _save(out, rank, result):
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))


class _PassEncoder(torch.nn.Module):
    def forward(self, x):
        return x


class _PassDecoder(torch.nn.Module):
    """Logits = the input; the deep-supervision logits = half of it."""

    def forward(self, x):
        return x, 0.5 * x


def ops_rank(rank, out, data):
    """Batch norm, the loss and accuracy, dropout and the canvas exchange,
    each on this rank's slice of ``data``'s global inputs."""
    import torch.distributed as dist

    from semseg_tpu_torch.models.layers import Dropout2d
    from semseg_tpu_torch.models.segmentation import SegmentationModel, set_process_group
    from semseg_tpu_torch.ops.norm import batch_norm_train
    from semseg_tpu_torch.parallel import distributed

    group = dist.group.WORLD
    result = {}
    for name, case in data["bn"].items():
        n = case["x"].shape[0] // 2
        rows = slice(rank * n, (rank + 1) * n)
        x = torch.from_numpy(case["x"][rows]).permute(0, 3, 1, 2).requires_grad_()
        w = torch.from_numpy(case["w"]).requires_grad_()
        b = torch.from_numpy(case["b"]).requires_grad_()
        stats = [torch.from_numpy(case[k]) for k in ("rm", "rv", "ri")]
        y, *new = batch_norm_train(x, w, b, *stats, group=group)
        y.backward(torch.from_numpy(case["dy"][rows]).permute(0, 3, 1, 2))
        result[name] = {"y": y.detach().permute(0, 2, 3, 1).numpy(),
                        "stats": [s.numpy() for s in new], "dx": x.grad.permute(0, 2, 3, 1).numpy(),
                        "dw": w.grad.numpy(), "db": b.grad.numpy()}

    logits, labels = data["loss"]
    n = logits.shape[0] // 2
    model = SegmentationModel(_PassEncoder(), _PassDecoder(), deep_sup_scale=0.4)
    set_process_group(model, group)
    x = torch.from_numpy(logits[rank * n:(rank + 1) * n]).permute(0, 3, 1, 2).requires_grad_()
    loss, acc = model(x, seg_label=torch.from_numpy(labels[rank * n:(rank + 1) * n]))
    loss.backward()
    result["loss"] = {"loss": loss.item(), "acc": acc.item(),
                      "dx": x.grad.permute(0, 2, 3, 1).numpy()}

    drop = Dropout2d(0.5).train()
    drop.generator = torch.Generator().manual_seed(5)
    drop.process_group = group
    result["dropout"] = drop(torch.ones(1, 64, 2, 2, dtype=torch.float64)).numpy()

    exchange = distributed.CanvasExchange("test")
    result["canvas"] = [distributed._sync_batch_canvas(b, exchange, microbatched=m)
                        for b, m in data["canvas"][rank]]
    _save(out, rank, result)


def train_rank(rank, out, case):
    """Two steps of the small config's train step as rank ``rank``, float64
    parameters and compute, from the JAX model's weights
    (``case['weights']``: a file of the port's encoder and decoder state
    dicts), on
    this rank's own batches, padded here to the ranks' canvas. Saves the
    steps' metrics, the padded batches and the state."""
    import torch.distributed as dist

    from semseg_tpu_torch.config import cfg as default_cfg
    from semseg_tpu_torch.models import ModelBuilder
    from semseg_tpu_torch.models.layers import Dropout2d
    from semseg_tpu_torch.parallel import create_train_state, distributed, train_step

    cfg = default_cfg.clone()
    cfg.MODEL.arch_encoder = "resnet18dilated"
    cfg.MODEL.arch_decoder = "ppm_deepsup"
    cfg.MODEL.fc_dim = 512
    cfg.TRAIN.num_epoch = 2
    cfg.TRAIN.epoch_iters = 10
    cfg.TPU.compute_dtype = "float64"
    model = ModelBuilder.build_model(cfg, device="cpu").to(torch.float64)
    enc, dec = torch.load(case["weights"])
    model.encoder.load_state_dict(enc, strict=True)
    model.decoder.load_state_dict(dec, strict=True)
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.0
    state = create_train_state(cfg, model.train(), group=dist.group.WORLD)
    exchange = distributed.CanvasExchange("train")
    accum = case["grad_accum"]
    metrics, padded = [], []
    for batch in case["batches"][rank]:
        batch = distributed._sync_batch_canvas(batch, exchange, microbatched=accum > 1)
        padded.append(batch)
        m = train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, None, accum)
        metrics.append((float(m["loss"]), float(m["acc"])))
    _save(out, rank, {"metrics": metrics, "padded": padded, "step": state.step,
                      "encoder": model.encoder.state_dict(),
                      "decoder": model.decoder.state_dict()})


def train_cli_rank(rank, args, world, port, log):
    """A rank of ``cli.train --devices world`` that appends ``"<rank>
    <epoch>"`` to ``log`` for each checkpoint it writes."""
    from semseg_tpu_torch import checkpoint
    from semseg_tpu_torch.cli import train

    write = checkpoint._write

    def logged(ckpt_dir, epoch, snap):
        with open(log, "a") as f:
            f.write(f"{rank} {epoch}\n")
        write(ckpt_dir, epoch, snap)

    checkpoint._write = logged
    train._rank_main(rank, args, world, port)


def void_labels(rng, shape, void_share):
    """Random labels in [0, 150) with about ``void_share`` of them -1."""
    labels = rng.randint(0, 150, shape).astype(np.int32)
    labels[rng.rand(*shape) < void_share] = -1
    return labels
