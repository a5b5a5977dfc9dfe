"""Checkpoints (``semseg_tpu/checkpoint.py``).

The port reads reference-format ``.pth`` pairs (``encoder_<name>`` /
``decoder_<name>`` under ``cfg.DIR``), which load into its modules as they
are. The JAX package's own orbax directories are not read here: export them
to a ``.pth`` pair with ``semseg_tpu.models.export.save_reference_checkpoints``.

Training writes, per epoch N, into ``cfg.DIR``:

* ``encoder_epoch_N.pth`` / ``decoder_epoch_N.pth``, the reference's pair
  (with the SyncBN accumulators), which the eval and test CLIs read;
* ``state_epoch_N.pt``, ``torch.save`` of the full train state (step, model,
  optimizer with its momentum buffers, history), for an exact resume
  (``TRAIN.start_epoch N``);
* ``history_epoch_N.json``.

``AsyncSaver`` first copies the state on the device, then writes on one
thread while training goes on: PyTorch's optimizer updates the parameters
in place, so a writer reading the live tensors would race the next step.

In a data-parallel run every rank holds the same state, and only the
primary writes (``AsyncSaver`` too). ``save_train_state`` ends in a
barrier, so no rank goes on to read a file still being written; the
training CLI puts one after ``AsyncSaver.close()``. On resume every rank
reads the file onto its own card.
"""

from __future__ import annotations

import copy
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from semseg_tpu_torch.models.convert import load_reference_pth, reference_state_dict
from semseg_tpu_torch.parallel.distributed import barrier, is_primary

# The published ImageNet backbones (reference resnet.py, mobilenet.py,
# hrnet.py, resnext.py): only the file name is used, to find a copy in the
# local cache directory; nothing is downloaded.
PRETRAINED_URLS = {
    "resnet18": "http://sceneparsing.csail.mit.edu/model/pretrained_resnet/resnet18-imagenet.pth",
    "resnet50": "http://sceneparsing.csail.mit.edu/model/pretrained_resnet/resnet50-imagenet.pth",
    "resnet101": "http://sceneparsing.csail.mit.edu/model/pretrained_resnet/resnet101-imagenet.pth",
    "resnext101": "http://sceneparsing.csail.mit.edu/model/pretrained_resnet/resnext101-imagenet.pth",
    "mobilenetv2": "http://sceneparsing.csail.mit.edu/model/pretrained_resnet/mobilenet_v2.pth.tar",
    "hrnetv2": "http://sceneparsing.csail.mit.edu/model/pretrained_resnet/hrnetv2_w48-imagenet.pth",
}


def resolve_reference_checkpoint(cfg, name: str) -> None:
    """Point ``cfg.MODEL.weights_*`` at checkpoint ``name`` under cfg.DIR.

    No-op when ``name`` is empty or explicit weight paths are already set.
    A missing checkpoint raises, as the reference's eval/test do.
    """
    if not name or cfg.MODEL.weights_encoder:
        return
    enc = os.path.join(cfg.DIR, "encoder_" + name)
    native = os.path.join(cfg.DIR, name.replace(".pth", ""))
    if os.path.exists(enc):
        cfg.MODEL.weights_encoder = enc
        cfg.MODEL.weights_decoder = os.path.join(cfg.DIR, "decoder_" + name)
    elif os.path.isdir(native):
        raise ValueError(
            f"{native} is an orbax checkpoint of the JAX package; export it "
            "to an encoder_/decoder_ .pth pair with "
            "semseg_tpu.models.export.save_reference_checkpoints"
        )
    else:
        raise FileNotFoundError(
            f"checkpoint {name!r}: neither {enc} nor {native} exists"
        )


def _snapshot(state, history) -> dict:
    """The train state as one dict of tensors on their devices, copied."""
    def clone(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().clone()
        if isinstance(tree, dict):
            return {k: clone(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(clone(v) for v in tree)
        return copy.deepcopy(tree)

    return {
        "step": state.step,
        "encoder": clone(state.model.encoder.state_dict()),
        "decoder": clone(state.model.decoder.state_dict()),
        "optimizer": clone(state.optimizer.state_dict()),
        "history": copy.deepcopy(history),
    }


def _write(ckpt_dir: str, epoch: int, snap: dict) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    for part in ("encoder", "decoder"):
        torch.save(reference_state_dict(snap[part]),
                   os.path.join(ckpt_dir, f"{part}_epoch_{epoch}.pth"))
    torch.save(snap, os.path.join(ckpt_dir, f"state_epoch_{epoch}.pt"))
    if snap["history"] is not None:
        with open(os.path.join(ckpt_dir, f"history_epoch_{epoch}.json"), "w") as f:
            json.dump(snap["history"], f)


def save_train_state(ckpt_dir: str, epoch: int, state, history=None) -> None:
    """Write epoch ``epoch``'s files (module docstring) now, from the
    primary; every rank returns once they are written."""
    if is_primary():
        _write(ckpt_dir, epoch, _snapshot(state, history))
    barrier()


def restore_train_state(ckpt_dir: str, epoch: int, state):
    """Load ``state_epoch_N.pt`` into ``state`` (model, optimizer, step) in
    place. The history saved beside it is not restored: a resumed run
    records only the epochs it runs, as the JAX CLI does."""
    path = os.path.join(ckpt_dir, f"state_epoch_{epoch}.pt")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no train state for epoch {epoch}: {path}")
    snap = torch.load(path, map_location="cpu", weights_only=True)
    state.model.encoder.load_state_dict(snap["encoder"], strict=True)
    state.model.decoder.load_state_dict(snap["decoder"], strict=True)
    state.optimizer.load_state_dict(snap["optimizer"])
    state.step = int(snap["step"])


class AsyncSaver:
    """Background checkpoint writer for the training loop.

    ``save()`` copies the train state on its device (one ``clone`` per
    tensor) and returns; the device → host copy and the file writes run on
    one worker thread, overlapping the next epoch. A worker's error
    surfaces at the next ``save()``/``wait()``; ``close()`` waits for the
    last write. On a rank other than the primary ``save()`` does nothing.
    """

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-save")
        self._pending = []

    def save(self, ckpt_dir: str, epoch: int, state, history=None):
        if not is_primary():
            return
        self.wait()
        snap = _snapshot(state, history)
        event = None
        if torch.cuda.is_available() and next(state.model.parameters()).is_cuda:
            # The worker's copies to the host wait for the clones above.
            event = torch.cuda.Event()
            event.record()
        self._pending.append(self._pool.submit(self._run, ckpt_dir, epoch, snap, event))

    @staticmethod
    def _run(ckpt_dir, epoch, snap, event):
        if event is not None:
            event.synchronize()
        _write(ckpt_dir, epoch, snap)

    def wait(self):
        """Block until every queued save is written; re-raise failures."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self):
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)


def pretrained_backbone_path(arch: str, model_dir: str = "./pretrained"):
    """The local copy of ``arch``'s published ImageNet backbone, or None
    (with a warning) when the arch has none or the file is not in
    ``model_dir``: the port never downloads, and the encoder then trains
    from random initialisation, as the JAX package does offline."""
    key = arch.lower().replace("dilated", "")
    if key not in PRETRAINED_URLS:
        return None
    path = os.path.join(model_dir, os.path.basename(PRETRAINED_URLS[key]))
    if os.path.exists(path):
        return path
    sys.stderr.write(
        f"WARNING: no ImageNet weights for {arch} at {path}; the encoder will "
        f"train from random init. Put {PRETRAINED_URLS[key]} there, or set "
        "MODEL.pretrained_encoder False to silence this.\n"
    )
    return None


def load_pretrained_encoder(encoder: torch.nn.Module, path: str) -> None:
    """Load a published ImageNet backbone into ``encoder``: every encoder
    parameter must be in the file; its classifier (``fc.*``) and the keys
    the encoder does not have are left out, as the reference's dilation
    surgery after the ImageNet load leaves them."""
    state = load_reference_pth(path)
    if "state_dict" in state and isinstance(state["state_dict"], dict):
        state = state["state_dict"]
    own = encoder.state_dict()
    missing = [k for k, _ in encoder.named_parameters() if k not in state]
    if missing:
        raise KeyError(f"{path} lacks encoder parameters {missing[:5]}...")
    encoder.load_state_dict({k: state.get(k, v) for k, v in own.items()}, strict=True)
