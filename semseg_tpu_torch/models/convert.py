"""Weights bridge: reference ``.pth`` files and the JAX package's variables.

The port's ``state_dict`` keys are the reference's, ``_running_iter`` (the
SyncBN's bias-correction accumulator) included, so a reference-format file
loads as it is once the two raw accumulator buffers ``_tmp_running_mean``
and ``_tmp_running_var`` (``running * iter``, which the port does not hold)
are dropped (``load_reference_pth``). ``reference_state_dict`` writes them
back, so the trainer's ``.pth`` pairs are the reference's format.

``state_dicts_from_jax`` maps the JAX package's flax variables onto the same
keys, for every family, with the path tables of
``semseg_tpu/models/convert.py`` (``_resnet_prefix``, ``_mobilenet_prefix``,
``_hrnet_prefix``, ``_decoder_prefix`` with ``_decoder_torch_prefix``)
written out again here, without JAX:

* conv kernels HWIO → OIHW;
* BN ``scale``/``bias`` → ``weight``/``bias``, ``mean``/``var``/``iter``
  → ``running_mean``/``running_var``/``_running_iter`` (shape (1,)), so a
  JAX train state taken mid-training maps onto the port exactly;
  ``num_batches_tracked`` is 0.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

SYNCBN_ACCUMULATORS = ("_tmp_running_mean", "_tmp_running_var")


def load_reference_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference-format state_dict file, ready for a strict load."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in state.items() if not k.endswith(SYNCBN_ACCUMULATORS)}


def reference_state_dict(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A module's ``state`` on the CPU with the reference SyncBN's raw
    accumulators added (``_tmp_running_* = running_* * _running_iter``), as
    the reference's trainer saves its ``.pth`` files."""
    out = {k: v.detach().cpu() for k, v in state.items()}
    for key in [k for k in out if k.endswith("._running_iter")]:
        prefix = key[: -len("_running_iter")]
        for stat in ("mean", "var"):
            out[f"{prefix}_tmp_running_{stat}"] = out[f"{prefix}running_{stat}"] * out[key]
    return out


def _cb(path, i: int) -> int:
    """Slot of a ConvBN's conv (0) or BN (1) in its Sequential."""
    return 0 if path[i] == "conv" else 1


def _block_prefix(base: str, path) -> str:
    """A residual block's leaf: ``cb{k}`` → ``conv{k}``/``bn{k}``, or its
    ``downsample`` Sequential."""
    if path[0] == "downsample":
        return f"{base}.downsample.{_cb(path, 1)}"
    return f"{base}.{'conv' if path[1] == 'conv' else 'bn'}{path[0][2:]}"


def _resnet_prefix(path: Tuple[str, ...]) -> str:
    """ResNet/ResNeXt encoders (reference resnet.py, resnext.py)."""
    m = re.fullmatch(r"stem(\d)", path[0])
    if m:
        return f"{'conv' if path[1] == 'conv' else 'bn'}{m.group(1)}"
    m = re.fullmatch(r"layer(\d)_(\d+)", path[0])
    if m:
        return _block_prefix(f"layer{m.group(1)}.{m.group(2)}", path[1:])
    raise KeyError(path)


def _mobilenet_prefix(path: Tuple[str, ...]) -> str:
    """MobileNetV2 (reference mobilenet.py): a block's Sequential holds
    depthwise 0 / project 3 when t == 1 (block 1), else expand 0 /
    depthwise 3 / project 6."""
    idx = int(re.fullmatch(r"features_(\d+)", path[0]).group(1))
    if idx == 0:
        return f"features.0.{_cb(path, 1)}"
    seq = {"dw": 0, "project": 3} if idx == 1 else {"expand": 0, "dw": 3, "project": 6}
    return f"features.{idx}.conv.{seq[path[1]] + _cb(path, 2)}"


def _hrnet_prefix(path: Tuple[str, ...]) -> str:
    """HRNetV2 (reference hrnet.py)."""
    p0 = path[0]
    m = re.fullmatch(r"stem(\d)", p0)
    if m:
        return f"{'conv' if path[1] == 'conv' else 'bn'}{m.group(1)}"
    m = re.fullmatch(r"layer1_(\d+)", p0)
    if m:
        return _block_prefix(f"layer1.{m.group(1)}", path[1:])
    m = re.fullmatch(r"transition(\d)_(\d+)(?:_(\d+))?", p0)
    if m:  # width change: transition{s}.{i}.{0,1}; new branch: .{i}.{j}.{0,1}
        s, i, j = m.groups()
        return f"transition{s}.{i}.{'' if j is None else j + '.'}{_cb(path, 1)}"
    m = re.fullmatch(r"stage(\d)_(\d+)", p0)
    if m:
        base = f"stage{m.group(1)}.{m.group(2)}"
        mb = re.fullmatch(r"branch(\d+)_(\d+)", path[1])
        if mb:
            return _block_prefix(f"{base}.branches.{mb.group(1)}.{mb.group(2)}", path[2:])
        mf = re.fullmatch(r"fuse(\d+)_(\d+)(?:_(\d+))?", path[1])
        if mf:
            i, j, k = mf.groups()
            return f"{base}.fuse_layers.{i}.{j}.{'' if k is None else k + '.'}{_cb(path, 2)}"
    raise KeyError(path)


def _decoder_prefix(arch: str):
    """Decoder path table (reference models.py:327-586) for one arch."""
    upernet = arch.startswith("upernet")

    def prefix(path: Tuple[str, ...]) -> str:
        p0 = path[0]
        if p0 in ("cbr", "cbr_deepsup", "ppm_last_conv"):  # conv3x3_bn_relu
            return f"{p0}.{_cb(path, 1)}"
        if p0 == "conv_last_deepsup":
            return p0
        m = re.fullmatch(r"ppm_(\d+)", p0)
        if m:  # PPM branch: Sequential(pool 0, conv 1, BN 2, ReLU 3)
            return f"ppm.{m.group(1)}.{1 + _cb(path, 2)}"
        m = re.fullmatch(r"(ppm_conv|fpn_in)_(\d+)", p0)
        if m:  # UPerNet: Sequential(conv 0, BN 1, ReLU 2)
            return f"{m.group(1)}.{m.group(2)}.{_cb(path, 1)}"
        m = re.fullmatch(r"fpn_out_(\d+)", p0)
        if m:  # Sequential(conv3x3_bn_relu): one more level
            return f"fpn_out.{m.group(1)}.0.{_cb(path, 1)}"
        if p0 == "conv_last_cbr":
            # PPM: conv_last = Sequential(conv 0, BN 1, ReLU, Dropout, conv 4);
            # UPerNet: conv_last = Sequential(conv3x3_bn_relu 0, conv 1).
            return f"conv_last.{'0.' if upernet else ''}{_cb(path, 1)}"
        if p0 == "conv_last":
            return "conv_last.1" if upernet else "conv_last.4" if arch.startswith("ppm") \
                else "conv_last"
        raise KeyError(path)

    return prefix


def _encoder_prefix(arch: str):
    if arch.startswith("mobilenet"):
        return _mobilenet_prefix
    if arch.startswith("hrnet"):
        return _hrnet_prefix
    return _resnet_prefix


def _leaves(tree, path=()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def _component(variables, component: str, prefix_fn,
               dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
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
                key = f"{prefix_fn(mod_path)}._running_iter"
                value = np.reshape(arr, (1,))
            else:
                name = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                        "var": "running_var"}[leaf]
                key = f"{prefix_fn(mod_path)}.{name}"
                value = arr
            out[key] = torch.tensor(np.asarray(value)).to(dtype)
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return out


def state_dicts_from_jax(variables, arch_encoder: str, arch_decoder: str,
                         dtype: torch.dtype = torch.float32):
    """(encoder, decoder) state_dicts from the JAX package's variables.

    ``variables`` is the nested ``{'params': ..., 'batch_stats': ...}`` dict
    of numpy arrays (``jax.tree.map(np.asarray, variables)``); the tensors
    come out in ``dtype`` (float32, as checkpoints hold them).
    """
    return (_component(variables, "encoder", _encoder_prefix(arch_encoder.lower()), dtype),
            _component(variables, "decoder", _decoder_prefix(arch_decoder.lower()), dtype))
