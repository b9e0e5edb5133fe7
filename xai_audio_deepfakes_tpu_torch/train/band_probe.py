"""Per-frame band-information probe for SSL features (port of
`train/band_probe.py`).

A linear softmax readout from per-frame features to the clip's artifact-band
class separates two explanations of a decoder that cannot localise: the
features carry no per-frame band information, or the decoder is too small.
If a linear probe recovers the band per frame, the information is there.
The train / test split is by clip, so no clip's frames leak across it.

`fit_softmax_probe` runs full-batch L-BFGS on the device through the
driver of the port's `fit_logreg` (`train_logreg.lbfgs_fit`), with the stop
rule of the JAX package's fit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from xai_audio_deepfakes_tpu_torch.device import resolve_device
from xai_audio_deepfakes_tpu_torch.train.train_logreg import lbfgs_fit


def softmax_probe_objective(params: dict, x: torch.Tensor, y: torch.Tensor,
                            l2: float) -> torch.Tensor:
    """The summed multinomial log-loss plus l2 / 2 ||W||^2 (bias free).
    `F.cross_entropy`'s gradient is softmax(z) - onehot(y) everywhere, as
    JAX's `log_softmax` gives it."""
    logits = x @ params["weight"] + params["bias"]
    return F.cross_entropy(logits, y, reduction="sum") + 0.5 * l2 * (params["weight"] ** 2).sum()


def fit_softmax_probe(
    x: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    l2: float = 1e-4,
    max_iter: int = 400,
    tol: float = 1e-7,
    device="cuda",
) -> dict:
    """Full-batch multinomial logistic regression by L-BFGS on `device`:
    x [N, D] f32, y [N] class ids -> {"weight" [D, K], "bias" [K]} as numpy.
    It stops after the first step whose starting gradient has norm below
    tol * max(1, |objective|), or after `max_iter` steps."""
    dev = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    yt = torch.as_tensor(np.asarray(y, np.int64), device=dev)
    params = {"weight": torch.zeros((x.shape[1], n_classes), device=dev, requires_grad=True),
              "bias": torch.zeros((n_classes,), device=dev, requires_grad=True)}
    lbfgs_fit(lambda: softmax_probe_objective(params, xt, yt, l2), params, max_iter, tol)
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def probe_predict(params: dict, x: np.ndarray) -> np.ndarray:
    logits = np.asarray(x, dtype=np.float32) @ params["weight"] + params["bias"]
    return np.argmax(logits, axis=-1)


def frame_band_probe(
    feats: np.ndarray,
    band_cls: np.ndarray,
    n_classes: int,
    test_frac: float = 0.25,
    seed: int = 0,
    l2: float = 1e-4,
    device="cuda",
) -> dict:
    """feats [N, T, H] per-frame SSL features of manipulated clips,
    band_cls [N] each clip's artifact-band class -> the probe report.

    Three linear probes, evaluated on held-out clips:
      * mean_pool: clip-mean features -> band (the positive control);
      * per_frame: every frame labelled with its clip's band; frame-level
        accuracy and the clip-level majority vote;
      * shuffled: per_frame with the clips' labels permuted (the negative
        control: it must sit at chance, else the probe fits noise).
    The numpy `rng` draws as the JAX package's: one seed, the same split."""
    rng = np.random.default_rng(seed)
    n, t, h = feats.shape
    order = rng.permutation(n)
    n_te = max(1, int(round(n * test_frac)))
    te, tr = order[:n_te], order[n_te:]

    def fit(x, y):
        return fit_softmax_probe(x, y, n_classes, l2=l2, device=device)

    report = {"n_clips": int(n), "n_frames_per_clip": int(t), "n_classes": int(n_classes),
              "chance": 1.0 / n_classes}

    pooled = feats.mean(axis=1)
    p = fit(pooled[tr], band_cls[tr])
    report["mean_pool_acc"] = float(np.mean(probe_predict(p, pooled[te]) == band_cls[te]))

    x_tr, y_tr = feats[tr].reshape(-1, h), np.repeat(band_cls[tr], t)
    x_te, y_te = feats[te].reshape(-1, h), np.repeat(band_cls[te], t)
    p = fit(x_tr, y_tr)
    pred = probe_predict(p, x_te)
    report["frame_acc"] = float(np.mean(pred == y_te))
    votes = pred.reshape(n_te, t)
    maj = np.array([np.bincount(v, minlength=n_classes).argmax() for v in votes])
    report["clip_majority_acc"] = float(np.mean(maj == band_cls[te]))

    y_shuf = rng.permutation(band_cls[tr])
    p = fit(x_tr, np.repeat(y_shuf, t))
    report["shuffled_frame_acc"] = float(np.mean(probe_predict(p, x_te) == y_te))
    return report
