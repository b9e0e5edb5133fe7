"""Fixed-length clip contract: right zero-pad or head-crop to N samples
(port of `ops/pad.py`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_or_crop(x: torch.Tensor, num_samples: int) -> torch.Tensor:
    """[..., L] -> [..., num_samples]."""
    length = x.shape[-1]
    if length < num_samples:
        return F.pad(x, (0, num_samples - length))
    return x[..., :num_samples]
