"""Checkpoint resolution (``semseg_tpu/checkpoint.py``).

The port reads reference-format ``.pth`` pairs (``encoder_<name>`` /
``decoder_<name>`` under ``cfg.DIR``), which load into its modules as they
are. The JAX package's own orbax directories are not read here: export them
to a ``.pth`` pair with ``semseg_tpu.models.export.save_reference_checkpoints``.
"""

from __future__ import annotations

import os


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
