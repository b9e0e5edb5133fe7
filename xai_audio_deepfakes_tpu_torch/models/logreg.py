"""Frozen logistic-regression detector head (port of `models/logreg.py`):
params = {"weight": [D, 1], "bias": [1]}, sigmoid on top.

Heads are saved as the JAX package's `.npz` (keys `weight`, `bias`) and
imported from scikit-learn `LogisticRegression` joblib checkpoints
(`coef_` [1, D], `intercept_` [1]); joblib is imported only to read one.
A loaded head lives on `device` and is what `ADDvisorPipeline.logreg` holds.
"""

from __future__ import annotations

import numpy as np
import torch

from xai_audio_deepfakes_tpu_torch.device import resolve_device


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


def logreg_params_from_arrays(coef: np.ndarray, intercept: np.ndarray, device="cuda") -> dict:
    """sklearn-layout arrays (coef [1, D] or [D], intercept [1]) -> params."""
    dev = resolve_device(device)
    coef = np.asarray(coef, dtype=np.float32).reshape(1, -1)
    return {
        "weight": torch.from_numpy(np.ascontiguousarray(coef.T)).to(dev),
        "bias": torch.from_numpy(np.asarray(intercept, dtype=np.float32).reshape(-1)).to(dev),
    }


def logreg_params_from_joblib(path: str, device="cuda") -> dict:
    """A scikit-learn LogisticRegression joblib checkpoint -> params."""
    import joblib

    clf = joblib.load(path)
    return logreg_params_from_arrays(clf.coef_, clf.intercept_, device)


def logreg_params_save(params: dict, path: str) -> None:
    """params -> `.npz` with keys `weight` [D, 1] and `bias` [1], f32."""
    np.savez(path, **{k: params[k].detach().float().cpu().numpy() for k in ("weight", "bias")})


def logreg_params_load(path: str, device="cuda") -> dict:
    """The `.npz` of `logreg_params_save` (the port's or the JAX package's)
    -> params on `device`."""
    dev = resolve_device(device)
    with np.load(path) as z:
        return {k: torch.from_numpy(np.asarray(z[k], np.float32)).to(dev)
                for k in ("weight", "bias")}


def logreg_params_from_any(path: str, device="cuda") -> dict:
    """A head from either a `.npz` of `logreg_params_save` or a joblib
    checkpoint."""
    if path.endswith(".npz"):
        return logreg_params_load(path, device)
    return logreg_params_from_joblib(path, device)
