"""Frozen logistic-regression detector head (port of `models/logreg.py`):
params = {"weight": [D, 1], "bias": [1]}, sigmoid on top."""

from __future__ import annotations

import torch


def logreg_init(feature_dim: int, generator: torch.Generator, device) -> dict:
    """Random head: weight ~ N(0, 1/D), bias 0."""
    w = torch.randn((feature_dim, 1), generator=generator, device=device)
    return {
        "weight": w / feature_dim**0.5,
        "bias": torch.zeros((1,), device=device),
    }


def logreg_apply(params: dict, feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., D] -> (logits [..., 1], probs [..., 1])."""
    logits = feats @ params["weight"] + params["bias"]
    return logits, 1.0 / (1.0 + torch.exp(-logits))
