"""Detector (logistic-regression head) training (port of
`train/train_logreg.py`).

The reference fits scikit-learn's LogisticRegression(C=1e6) on the host.
Here the fit runs on the device: full-batch L-BFGS (`train/lbfgs.py`,
optax.lbfgs()'s algorithm, which the JAX package's fit runs; the driver
`lbfgs_fit` also fits `band_probe.fit_softmax_probe`) on sklearn's
objective, sum_i log(1 + exp(-z_i)) + ||w||^2 / (2C) with the bias
unregularised, and stops as the JAX package's fit does. Accuracy and EER
are the reference's reported pair; the params drop into
`ADDvisorPipeline.logreg` and `logreg_params_save`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from xai_audio_deepfakes_tpu_torch.device import resolve_device
from xai_audio_deepfakes_tpu_torch.metrics.eer import compute_eer
from xai_audio_deepfakes_tpu_torch.models.logreg import logreg_apply
from xai_audio_deepfakes_tpu_torch.train.lbfgs import LBFGS


def stratified_split(
    x: np.ndarray, y: np.ndarray, test_size: float = 0.2, seed: int = 42
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """80/20 stratified split (a copy of the JAX package's: the same seed
    gives the same split)."""
    rng = np.random.default_rng(seed)
    train_idx, test_idx = [], []
    for cls in np.unique(y):
        idx = np.flatnonzero(y == cls)
        rng.shuffle(idx)
        n_test = max(1, int(round(len(idx) * test_size)))
        test_idx.append(idx[:n_test])
        train_idx.append(idx[n_test:])
    tr = np.concatenate(train_idx)
    te = np.concatenate(test_idx)
    rng.shuffle(tr)
    rng.shuffle(te)
    return x[tr], x[te], y[tr], y[te]


def logreg_objective(params: dict, x: torch.Tensor, y: torch.Tensor, c: float) -> torch.Tensor:
    """sklearn's LogisticRegression objective for labels y in {0, 1}
    ([N, 1] f32): the summed log-loss plus ||w||^2 / (2C), the log-loss
    written y softplus(-z) + (1 - y) softplus(z). Its gradient,
    (1 - y) sigmoid(z) - y sigmoid(-z), keeps full f32 precision at every
    logit, and is sigmoid(0) - y at the fit's start, where every logit is 0.
    Where features outnumber rows the fit ends at |z| of 10-20, where
    sigmoid(z) - y (`binary_cross_entropy_with_logits`' gradient, and the
    JAX package's max(z, 0) + log1p(exp(-|z|)) summed as XLA sums it)
    keeps 7 significant bits of a row's term at |z| = 12 and none beyond
    17: the line searches then fail on the noise and the fit stalls short
    of the optimum. (Torch's derivatives at that form's kink give 1 - y at
    z = 0, from which the fit never leaves w = 0 on offset features.)"""
    z = logreg_apply(params, x)[0]
    nll = (y * F.softplus(-z) + (1.0 - y) * F.softplus(z)).sum()
    return nll + 0.5 / c * (params["weight"] ** 2).sum()


def lbfgs_fit(
    objective: Callable[[], torch.Tensor], params: dict, max_iter: int, tol: float
) -> tuple[int, int, float, float]:
    """Minimise `objective()` over the tensors of `params` in place by
    full-batch L-BFGS (`lbfgs.LBFGS`, as `optax.lbfgs()`). It stops as the
    JAX package's fits do: after the first step whose starting gradient has
    norm below tol * max(1, |objective|), or after `max_iter` steps.
    -> (steps, objective evaluations, the last step's starting objective
    and gradient norm)."""
    tensors = list(params.values())
    sizes = [p.numel() for p in tensors]

    def load(x):
        with torch.no_grad():
            for p, v in zip(tensors, x.split(sizes)):
                p.copy_(v.view_as(p))

    def value_and_grad(x):
        load(x)
        with torch.enable_grad():
            loss = objective()
            grads = torch.autograd.grad(loss, tensors)
        return loss, torch.cat([g.reshape(-1) for g in grads])

    opt = LBFGS(value_and_grad, torch.cat([p.detach().reshape(-1) for p in tensors]))
    steps = 0
    for steps in range(1, max_iter + 1):
        value, gnorm = opt.step()
        if gnorm < tol * max(1.0, abs(value)):
            break
    load(opt.x)
    return steps, opt.evaluations, value, gnorm


def fit_logreg(
    x: np.ndarray,
    y: np.ndarray,
    c: float = 1e6,
    max_iter: int = 1000,
    tol: float = 1e-7,
    device="cuda",
    log_fn: Callable[[dict], None] | None = None,
) -> dict:
    """Full-batch L2-regularised logistic regression by L-BFGS on `device`
    -> params {"weight": [D, 1], "bias": [1]}. With `log_fn`, the fit's
    steps, objective evaluations, final objective and gradient norm are
    logged as {"lbfgs": {...}}."""
    dev = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    yt = torch.as_tensor(np.asarray(y, np.float32), device=dev)[:, None]
    params = {"weight": torch.zeros((x.shape[1], 1), device=dev, requires_grad=True),
              "bias": torch.zeros((1,), device=dev, requires_grad=True)}
    steps, evaluations, value, gnorm = lbfgs_fit(
        lambda: logreg_objective(params, xt, yt, c), params, max_iter, tol)
    if log_fn is not None:
        log_fn({"lbfgs": {"steps": steps, "evaluations": evaluations, "objective": value,
                          "gnorm": gnorm}})
    return {k: v.detach() for k, v in params.items()}


def evaluate_logreg(params: dict, x: np.ndarray, y: np.ndarray) -> dict:
    """Accuracy (probability above 0.5) and EER on (x, y)."""
    feats = torch.as_tensor(np.asarray(x, np.float32), device=params["weight"].device)
    with torch.no_grad():
        scores = logreg_apply(params, feats)[1][:, 0].cpu().numpy()
    pred = (scores > 0.5).astype(np.int64)
    return {"accuracy": float(np.mean(pred == np.asarray(y))), "eer": compute_eer(scores, y)}


def train_detector(
    x: np.ndarray,
    y: np.ndarray,
    c: float = 1e6,
    test_size: float = 0.2,
    seed: int = 42,
    log_fn: Callable[[dict], None] | None = None,
    device="cuda",
) -> tuple[dict, dict]:
    """Split, fit, evaluate -> (params, metrics)."""
    x_tr, x_te, y_tr, y_te = stratified_split(x, y, test_size, seed)
    params = fit_logreg(x_tr, y_tr, c=c, device=device, log_fn=log_fn)
    metrics = evaluate_logreg(params, x_te, y_te)
    if log_fn is not None:
        log_fn({"detector": metrics})
    return params, metrics
