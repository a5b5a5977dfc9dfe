"""Exported serving bundles: segmentation without model code
(``semseg_tpu/serving.py``).

``export_bundle`` writes one ``torch.export`` program per (batch, H, W)
bucket and the parameters once (``params.pt``). ``Predictor`` runs a bundle
with no model zoo on the serving host: it imports the pool's registered
operators (``ops.kernels.ppm_pool``) and nothing of
``semseg_tpu_torch.models``.

Program semantics per bucket (the single-scale reference protocol,
``test.py:55-91`` minus multi-scale averaging), as in the JAX package:
  uint8 NHWC batch → normalize (f32, MEAN/STD) → model forward → bilinear
  resize of the logits to the input resolution (align_corners=False) →
  argmax → uint8 label map.
``argmax(softmax(x)) == argmax(x)``, so the softmax is left out. The PPM
pool stays one ``semseg_tpu_torch::pyramid_pool`` node of the program, so
on the card the program launches the hand-written kernel.

Each program takes the parameters as inputs, in the manifest's order: the
model is traced from a ``meta`` copy with the parameters swapped in
(``torch.func.functional_call``) and the example inputs are dropped before
saving, so a program file holds the graph and no weights.

Deliberate difference from the JAX package: a JAX bundle is lowered for
several platforms at once (``platforms=``); a ``torch.export`` program
holds its constants (the MEAN/STD tensors of ``ops.preproc``) on the
device type it was exported on. The manifest names that device type (and
the card's index), and ``Predictor`` raises on a bundle exported for
another type instead of moving it. Within the type it moves: a bundle
exported on card 0 runs on card 1 (``torch.export.passes.
move_to_device_pass`` moves the program's constants and the devices its
graph names).

Inputs of other sizes are resized onto the nearest exported bucket (the
eval pipeline's bucket-by-resize discipline) and the label map is
nearest-resized back.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Sequence, Tuple

import numpy as np
import torch

# Registers the pool's operators, which the programs call.
from semseg_tpu_torch.ops.kernels import ppm_pool  # noqa: F401
from semseg_tpu_torch.ops.preproc import normalize_255
from semseg_tpu_torch.ops.resize import resize_bilinear

FORMAT = "semseg_tpu_torch.serving/1"
_MANIFEST = "manifest.json"
_PARAMS = "params.pt"


class _Program(torch.nn.Module):
    """(parameters, uint8 (N, h, w, 3)) → uint8 (N, h, w) label maps.

    The model is held outside the module's registry, so the export records
    none of its tensors: every parameter and buffer comes in as an input.
    """

    def __init__(self, model, names, h: int, w: int):
        super().__init__()
        self._model = (model,)
        self.names = list(names)
        self.hw = (h, w)

    def forward(self, params, img_u8):
        (model,) = self._model
        x = normalize_255(img_u8.to(torch.float32))
        logits = torch.func.functional_call(
            model, dict(zip(self.names, params)), (x.permute(0, 3, 1, 2),))
        full = resize_bilinear(logits.to(torch.float32), self.hw)
        return full.argmax(dim=1).to(torch.uint8)


def export_bundle(
    model,
    out_dir: str,
    *,
    shapes: Sequence[Tuple[int, int]],
    batch_size: int = 1,
    num_class: int = 150,
) -> dict:
    """Export one program per (batch, h, w) bucket of the eval-mode
    ``model`` into ``out_dir``, on the device ``model`` lies on.

    The parameters are saved once (``params.pt``) and passed to every
    program as inputs: a program that closed over them would carry the
    ~200 MB of the flagship's weights in every bucket's file.
    """
    if num_class >= 256:
        raise ValueError("uint8 label transport needs num_class < 256")
    os.makedirs(out_dir, exist_ok=True)
    state = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    names = sorted(state)
    device = next(iter(state.values())).device
    params = [state[k].detach() for k in names]
    torch.save({k: p for k, p in zip(names, params)}, os.path.join(out_dir, _PARAMS))
    # The trace runs the model's Python with the parameters swapped in;
    # a meta copy guarantees that no weight of its own can reach a file.
    meta = copy.deepcopy(model).to("meta")
    # Run the normalisation once eagerly, so that its constants are
    # cached as real tensors on the device before the trace reads them.
    normalize_255(torch.zeros(1, 1, 1, 3, device=device))

    programs = []
    for h, w in shapes:
        img = torch.zeros((batch_size, h, w, 3), dtype=torch.uint8, device=device)
        with torch.no_grad():
            exp = torch.export.export(_Program(meta, names, h, w), (params, img))
        exp.example_inputs = None  # the parameters, otherwise saved with it
        name = f"{batch_size}x{h}x{w}.pt2"
        torch.export.save(exp, os.path.join(out_dir, name))
        programs.append({"h": h, "w": w, "batch": batch_size, "file": name})

    manifest = {
        "format": FORMAT,
        "num_class": num_class,
        "programs": programs,
        "params": names,
        "device": device.type,
        "device_index": device.index,
        "torch_version": torch.__version__,
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class Predictor:
    """Runs an exported bundle on ``device``: needs only torch, numpy, PIL
    and the pool's operators.

    The parameters go to the device once, at load time, and stay there.
    A bundle exported on another device type raises; one exported on
    another card of the type is moved to ``device``.
    """

    def __init__(self, bundle_dir: str, *, device="cuda"):
        with open(os.path.join(bundle_dir, _MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest["format"] != FORMAT:
            raise ValueError(f"{bundle_dir}: format {self.manifest['format']!r}, "
                             f"expected {FORMAT!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if self.manifest["device"] != self.device.type:
            raise ValueError(
                f"{bundle_dir} was exported on {self.manifest['device']!r} and holds "
                f"its constants there; export it again on {self.device.type!r}"
            )
        state = torch.load(os.path.join(bundle_dir, _PARAMS), map_location="cpu",
                           weights_only=True)
        self.params = [state[k].to(self.device) for k in self.manifest["params"]]
        self.programs = {}
        for p in self.manifest["programs"]:
            exp = torch.export.load(os.path.join(bundle_dir, p["file"]))
            if self.device.index != self.manifest.get("device_index", self.device.index):
                from torch.export.passes import move_to_device_pass

                exp = move_to_device_pass(exp, self.device)
            self.programs[(p["batch"], p["h"], p["w"])] = exp.module()

    def _pick(self, h, w):
        """Exported bucket with the closest aspect-preserving fit."""

        def cost(key):
            _, bh, bw = key
            s = min(bh / h, bw / w)
            return abs(1 - s) + abs(bh / bw - h / w)

        return min(self.programs, key=cost)

    def predict(self, img: np.ndarray) -> np.ndarray:
        """uint8 (H, W, 3) image → int64 (H, W) label map (0-based)."""
        return self.predict_batch([img])[0]

    @torch.no_grad()
    def predict_batch(self, imgs) -> list:
        """Segment a list of uint8 (H, W, 3) images.

        Images are grouped by their picked bucket and packed into the
        exported batch dimension (final partial chunks pad with zero
        images, whose outputs are dropped): one program call per chunk.
        """
        from PIL import Image

        by_key: dict = {}
        for idx, img in enumerate(imgs):
            by_key.setdefault(self._pick(*img.shape[:2]), []).append(idx)

        out: list = [None] * len(imgs)
        for key, indices in by_key.items():
            b, bh, bw = key
            resized = [
                np.asarray(Image.fromarray(imgs[i]).resize((bw, bh), Image.BILINEAR),
                           np.uint8)
                for i in indices
            ]
            for lo in range(0, len(indices), b):
                chunk = indices[lo: lo + b]
                batch = np.zeros((b, bh, bw, 3), np.uint8)
                for j in range(len(chunk)):
                    batch[j] = resized[lo + j]
                maps = self.programs[key](
                    self.params, torch.from_numpy(batch).to(self.device)).cpu().numpy()
                for j, i in enumerate(chunk):
                    H, W = imgs[i].shape[:2]
                    m = maps[j]
                    if (bh, bw) != (H, W):
                        m = np.asarray(Image.fromarray(m).resize((W, H), Image.NEAREST))
                    out[i] = m.astype(np.int64)
        return out
