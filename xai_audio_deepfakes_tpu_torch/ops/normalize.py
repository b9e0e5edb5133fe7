"""Per-utterance normalisation before the embedder (port of
`ops/normalize.py`): zero mean, divided by (unbiased std + eps), with eps
added outside the square root."""

from __future__ import annotations

import torch


def zero_mean_unit_var_norm(x: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """[..., L] -> normalised [..., L]."""
    centered = x - x.mean(dim=-1, keepdim=True)
    n = x.shape[-1]
    var = (centered * centered).sum(dim=-1, keepdim=True) / max(n - 1, 1)
    return centered / (torch.sqrt(var) + eps)
