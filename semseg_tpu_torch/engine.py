"""Multi-scale inference engine (``semseg_tpu/engine.py``), exact mode.

``InferenceEngine(exact=True)`` is the reference computation op for op: for
every level of a host pyramid, the full forward with the in-model bilinear
resize to label size and softmax, then the mean over levels and the argmax.
The mean stays in float32 on the device; ``predict`` fetches only the
argmax map. The batched, packed and device-pyramid engines are not ported
yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from semseg_tpu.data.transforms import MEAN, STD


class InferenceEngine:
    def __init__(self, model, *, num_class: int = 150, device="cuda",
                 exact: bool = True):
        if not exact:
            raise NotImplementedError(
                "only the exact engine is ported; the batched engine is "
                "ROADMAP item 5"
            )
        self.model = model
        self.num_class = num_class
        self.device = torch.device(device)

    def _to_device(self, img: np.ndarray) -> torch.Tensor:
        """(1, H, W, 3) host image → normalized NCHW channels_last tensor."""
        if img.dtype == np.uint8:
            img = ((img.astype(np.float32) / 255.0) - MEAN) / STD
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(self.device)
        # An NHWC tensor seen as NCHW is channels_last without a copy.
        return x.permute(0, 3, 1, 2)

    @torch.inference_mode()
    def mean_scores(self, pyramid: Sequence[np.ndarray], seg_size) -> torch.Tensor:
        """(num_class, H, W) float32 softmax scores averaged over the pyramid,
        on the device."""
        acc = torch.zeros((self.num_class, *seg_size), dtype=torch.float32,
                          device=self.device)
        for img in pyramid:
            acc += self.model(self._to_device(img), tuple(seg_size))[0]
        return acc / len(pyramid)

    def scores_for_pyramid(self, pyramid: Sequence[np.ndarray], seg_size) -> np.ndarray:
        """(H, W, num_class) float32 scores (mean over scales), on the host."""
        return self.mean_scores(pyramid, seg_size).permute(1, 2, 0).cpu().numpy()

    def predict(self, pyramid: Sequence[np.ndarray], seg_size) -> np.ndarray:
        """Argmax class map at ``seg_size`` (reference eval.py:74-75)."""
        return self.mean_scores(pyramid, seg_size).argmax(0).cpu().numpy()
