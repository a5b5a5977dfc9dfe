"""Weights bridge: reference ``.pth`` files and the JAX package's variables.

The port's ``state_dict`` keys are the reference's, so a reference-format
file loads as it is once the reference SyncBN's accumulator buffers
(``_tmp_running_mean``, ``_tmp_running_var``, ``_running_iter``), which
``nn.BatchNorm2d`` does not hold, are dropped (``load_reference_pth``).

``state_dicts_from_jax`` maps the JAX package's flax variables onto the same
keys, with the path tables of ``semseg_tpu/models/convert.py``
(``_resnet_prefix``, ``_decoder_torch_prefix``) written out again here, without
JAX, for the resnet and ppm families:

* conv kernels HWIO → OIHW;
* BN ``scale``/``bias`` → ``weight``/``bias``, ``mean``/``var`` →
  ``running_mean``/``running_var``; ``num_batches_tracked`` is 0.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

SYNCBN_ACCUMULATORS = ("_tmp_running_mean", "_tmp_running_var", "_running_iter")


def load_reference_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference-format state_dict file, ready for a strict load."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in state.items() if not k.endswith(SYNCBN_ACCUMULATORS)}


def _resnet_prefix(path: Tuple[str, ...]) -> str:
    m = re.fullmatch(r"stem(\d)", path[0])
    if m:
        return f"{'conv' if path[1] == 'conv' else 'bn'}{m.group(1)}"
    m = re.fullmatch(r"layer(\d)_(\d+)", path[0])
    if m:
        base = f"layer{m.group(1)}.{m.group(2)}"
        if path[1] == "downsample":
            return f"{base}.downsample.{0 if path[2] == 'conv' else 1}"
        return f"{base}.{'conv' if path[2] == 'conv' else 'bn'}{path[1][2:]}"
    raise KeyError(path)


def _ppm_prefix(path: Tuple[str, ...]) -> str:
    p0 = path[0]
    if p0 == "cbr_deepsup":
        return f"cbr_deepsup.{0 if path[1] == 'conv' else 1}"
    if p0 == "conv_last_deepsup":
        return p0
    m = re.fullmatch(r"ppm_(\d+)", p0)
    if m:  # Sequential(pool 0, conv 1, BN 2, ReLU 3)
        return f"ppm.{m.group(1)}.{1 if path[2] == 'conv' else 2}"
    if p0 == "conv_last_cbr":  # Sequential(conv 0, BN 1, ReLU, Dropout, conv 4)
        return f"conv_last.{0 if path[1] == 'conv' else 1}"
    if p0 == "conv_last":
        return "conv_last.4"
    raise KeyError(path)


_PREFIX_FN = {"resnet50dilated": _resnet_prefix, "ppm_deepsup": _ppm_prefix}


def _leaves(tree, path=()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def _component(variables, component: str, prefix_fn) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, arr in _leaves(variables.get(coll, {}).get(component, {})):
            mod_path, leaf = path[:-1], path[-1]
            if leaf == "kernel":
                # A ConvBN's kernel sits under its "conv" submodule; a bare
                # Conv (conv_last) carries it directly.
                prefix = prefix_fn(mod_path if mod_path[-1] == "conv" else mod_path + ("conv",))
                value = np.transpose(arr, (3, 2, 0, 1))
                key = f"{prefix}.weight"
            elif leaf == "iter":
                continue  # no counterpart in nn.BatchNorm2d
            else:
                name = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                        "var": "running_var"}[leaf]
                key = f"{prefix_fn(mod_path)}.{name}"
                value = arr
            out[key] = torch.tensor(np.asarray(value, np.float32))
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return out


def state_dicts_from_jax(variables, arch_encoder: str, arch_decoder: str):
    """(encoder, decoder) state_dicts from the JAX package's variables.

    ``variables`` is the nested ``{'params': ..., 'batch_stats': ...}`` dict
    of numpy arrays (``jax.tree.map(np.asarray, variables)``).
    """
    out = []
    for component, arch in (("encoder", arch_encoder), ("decoder", arch_decoder)):
        if arch.lower() not in _PREFIX_FN:
            raise NotImplementedError(f"no weight mapping for {arch!r} yet")
        out.append(_component(variables, component, _PREFIX_FN[arch.lower()]))
    return tuple(out)
