"""Accumulation-dtype policy (``semseg_tpu/ops/dtypes.py``).

bfloat16 and float32 compute accumulate in float32; float64 stays float64.
"""

from __future__ import annotations

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """float64 stays float64; everything else accumulates in float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32
