"""Plain reference of the training step, followed from the seed's weights
through the first steps of a run.

A step: the uint8 batch normalised (ImageNet mean and std, zero beyond
each image's extent); the training forward (batch statistics, Dropout2d
with the given keep masks, the deep-supervision head); the loss, the
masked softmax cross-entropy (void -1 ignored, the sum over labelled pixels
divided by their count, at least 1) of the logits plus ``deep_sup_scale``
times that of the deep-supervision logits; autograd's gradients; SGD with
momentum in two groups (encoder, decoder), weight decay on conv weights
only, the learning rate ``lr * (1 - step / max_iters) ** lr_pow`` of the
step before it counts; BN's running statistics replaced by the forward's
bias-corrected averages.

With ``ranks`` (a data-parallel run), each batch is the global one, and
the statistics, the dropout masks and the loss are over all of it, as the
reference's synchronised BN and the global-batch loss define them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List

import torch

from .evaluate import MEAN, STD
from .model import Arch, Model, Numerics


@dataclass
class Hyper:
    lr_encoder: float
    lr_decoder: float
    lr_pow: float
    momentum: float
    weight_decay: float
    deep_sup_scale: float
    max_iters: int


@dataclass
class Followed:
    """What the reference read over its steps: each step's loss, each
    leaf's first gradient as SGD takes it (with its decay) and its norm,
    and each leaf's change after the last step (BN running statistics
    included)."""

    losses: List[float] = field(default_factory=list)
    grad_norms: Dict[str, float] = field(default_factory=dict)
    change_norms: Dict[str, float] = field(default_factory=dict)


def normalise(img_u8: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 → (N, 3, H, W) float32 normalised, zero beyond
    each image's (h, w)."""
    n, h, w, _ = img_u8.shape
    dev = img_u8.device
    mean = torch.tensor(MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(STD, dtype=torch.float32, device=dev)
    x = (img_u8.to(torch.float32) / 255.0 - mean) / std
    rows = torch.arange(h, device=dev).view(1, h, 1)
    cols = torch.arange(w, device=dev).view(1, 1, w)
    inside = (rows < valid_hw[:, 0].view(n, 1, 1)) & (cols < valid_hw[:, 1].view(n, 1, 1))
    return torch.where(inside[..., None], x, 0.0).permute(0, 3, 1, 2)


def cross_entropy(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    valid = label != -1
    lse = torch.logsumexp(logits, dim=1)
    pick = logits.gather(1, torch.where(valid, label, 0).long().unsqueeze(1)).squeeze(1)
    return torch.where(valid, lse - pick, 0.0).sum() / valid.sum().clamp(min=1)


def follow(params0: Dict[str, torch.Tensor], arch: Arch, hyper: Hyper, batches: List[dict],
           masks: Callable[[int, int], List[torch.Tensor]], num: Numerics,
           remat: bool = False) -> Followed:
    """``len(batches)`` steps from ``params0``. ``batches``: host dicts
    (``img_data``, ``img_valid_hw``, ``seg_label``) of the global batch;
    ``masks(step, n)``: the keep masks the step's forward draws, in order;
    ``remat``: recompute each encoder block in the backward (memory only)."""
    dev = next(iter(params0.values())).device
    params = {k: v.detach().clone() for k, v in params0.items()}
    leaves = [k for k, v in params.items()
              if v.dtype.is_floating_point and not k.endswith(
                  (".running_mean", ".running_var", "._running_iter"))]
    for k in leaves:
        params[k] = params[k].to(num.dtype).requires_grad_(True)
    buffers = [k for k in params if k.endswith((".running_mean", ".running_var"))]
    momentum: Dict[str, torch.Tensor] = {}
    out = Followed()
    for step, batch in enumerate(batches):
        img = torch.as_tensor(batch["img_data"], device=dev)
        vhw = torch.as_tensor(batch["img_valid_hw"], device=dev)
        label = torch.as_tensor(batch["seg_label"], device=dev)
        model = Model(params, arch, num, training=True, masks=masks(step, img.shape[0]),
                      remat=remat)
        logits, deepsup = model.forward(normalise(img, vhw))
        loss = cross_entropy(logits, label)
        if deepsup is not None:
            loss = loss + hyper.deep_sup_scale * cross_entropy(deepsup, label)
        grads = torch.autograd.grad(loss, [params[k] for k in leaves])
        out.losses.append(float(loss.detach()))
        frac = min(max(1.0 - step / hyper.max_iters, 0.0), 1.0) ** hyper.lr_pow
        with torch.no_grad():
            for k, g in zip(leaves, grads):
                p = params[k]
                d = g + hyper.weight_decay * p if p.dim() > 1 else g
                momentum[k] = d.clone() if step == 0 else momentum[k] * hyper.momentum + d
                if step == 0:
                    out.grad_norms[k] = float(d.norm())
                lr = hyper.lr_encoder if k.startswith("encoder.") else hyper.lr_decoder
                p.sub_(lr * frac * momentum[k])
            for name, (mean, var, it) in model.new_stats.items():
                params[name + ".running_mean"] = mean.to(params[name + ".running_mean"].dtype)
                params[name + ".running_var"] = var.to(params[name + ".running_var"].dtype)
                params[name + "._running_iter"] = it.to(params[name + "._running_iter"].dtype)
        del logits, deepsup, loss, grads, model
    with torch.no_grad():
        for k in leaves + buffers:
            out.change_norms[k] = float((params[k].double() - params0[k].double()).norm())
    return out
