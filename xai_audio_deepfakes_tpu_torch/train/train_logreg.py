"""Detector (logistic-regression head) training (port of
`train/train_logreg.py`).

The reference fits scikit-learn's LogisticRegression(C=1e6) on the host.
Here the fit runs on the device: full-batch L-BFGS (`torch.optim.LBFGS`,
strong-Wolfe line search, 10 pairs of history, as `optax.lbfgs`; the
driver `lbfgs_fit` also fits `band_probe.fit_softmax_probe`) on sklearn's
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
    ([N, 1] f32): the summed log-loss plus ||w||^2 / (2C). The log-loss is
    `binary_cross_entropy_with_logits`, whose gradient is sigmoid(z) - y
    everywhere. (The JAX package's max(z, 0) + log1p(exp(-|z|)) has a kink
    at z = 0 in each term, where torch's derivatives of `clamp_min` and
    `abs` give 1 - y, not JAX's 0.5 - y: every logit is 0 at the fit's
    start, and from that wrong first gradient L-BFGS never left w = 0 on
    features with a common offset, as pooled embeddings have.)"""
    logits = logreg_apply(params, x)[0]
    nll = F.binary_cross_entropy_with_logits(logits, y, reduction="sum")
    return nll + 0.5 / c * (params["weight"] ** 2).sum()


def lbfgs_fit(
    objective: Callable[[], torch.Tensor], params: dict, max_iter: int, tol: float
) -> tuple[int, int, float, float]:
    """Minimise `objective()` over the tensors of `params` in place by
    full-batch L-BFGS (strong-Wolfe line search, 10 pairs of history, as
    `optax.lbfgs`). It stops as the JAX package's fits do: after the first
    step whose starting gradient has norm below tol * max(1, |objective|),
    or after `max_iter` steps. -> (steps, objective evaluations, the last
    step's starting objective and gradient norm)."""
    tensors = list(params.values())
    # one L-BFGS iteration per step(), torch's own stopping tests off, so that
    # the rule above decides. torch caps the line search at max_eval less the
    # step's first evaluation; its default max_eval for one iteration (1)
    # would leave the search no evaluation, and L-BFGS stalls
    opt = torch.optim.LBFGS(tensors, lr=1.0, max_iter=1, max_eval=1 + 25, history_size=10,
                            tolerance_grad=0.0, tolerance_change=0.0,
                            line_search_fn="strong_wolfe")
    start: list = []

    def closure():
        opt.zero_grad()
        loss = objective()
        loss.backward()
        if not start:  # the first evaluation of a step is at its starting point
            start.append((loss.detach(), torch.cat([p.grad.flatten() for p in tensors]).norm()))
        return loss

    steps = 0
    for steps in range(1, max_iter + 1):
        start.clear()
        opt.step(closure)
        value, gnorm = (float(v) for v in start[0])
        if gnorm < tol * max(1.0, abs(value)):
            break
    return steps, opt.state[tensors[0]]["func_evals"], value, gnorm


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
