"""Gradient attribution over the waveform input (port of
`attrib/methods.py`, the Captum baselines of the reference).

Each method is a combinator over `score_fn: wav [B, L] -> logits [B, 1]`;
the gradient is `torch.autograd.grad` of the summed score, which equals the
per-clip gradient because each row's score depends on that row only.

  saliency:          |d score / d wav|
  input_x_gradient:  wav * d score / d wav
  integrated_grads:  (wav - baseline) * mean_k grad(baseline + a_k (wav -
                     baseline)), a_k = (k + 0.5) / steps, the midpoint grid
                     the JAX code uses (its docstring says "left Riemann")
  smoothgrad:        mean_k grad(wav + sigma * span * n_k)
  gradient_shap:     mean_k [(wav - b_k) * grad(b_k + u_k (wav - b_k) +
                     sigma * span * n_k)], b_k drawn from `baselines`

`span` is max(wav) - min(wav) over the whole batch, not per clip, as in the
JAX package. The random draws come from a `torch.Generator`; the
`_smoothgrad` and `_gradient_shap` functions take the draws themselves
(standard normals n, baseline indices, u), so that a test can feed them
another generator's draws.
"""

from __future__ import annotations

from typing import Callable

import torch

ScoreFn = Callable[[torch.Tensor], torch.Tensor]


def _grad(score_fn: ScoreFn, wav: torch.Tensor) -> torch.Tensor:
    """d sum(score_fn(wav)) / d wav, detached."""
    w = wav.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(score_fn(w).sum(), w)
    return g


def saliency(score_fn: ScoreFn, wav: torch.Tensor) -> torch.Tensor:
    return _grad(score_fn, wav).abs()


def input_x_gradient(score_fn: ScoreFn, wav: torch.Tensor) -> torch.Tensor:
    return wav * _grad(score_fn, wav)


def integrated_gradients(score_fn: ScoreFn, wav: torch.Tensor,
                         baseline: torch.Tensor | None = None, steps: int = 32) -> torch.Tensor:
    """Midpoint Riemann sum over `steps` points of the straight path from
    `baseline` (zeros by default) to `wav`."""
    if baseline is None:
        baseline = torch.zeros_like(wav)
    delta = wav - baseline
    alphas = (torch.arange(steps, dtype=wav.dtype, device=wav.device) + 0.5) / steps
    total = torch.zeros_like(wav)
    for a in alphas:
        total = total + _grad(score_fn, baseline + a * delta)
    return delta * total / steps


def _smoothgrad(score_fn: ScoreFn, wav: torch.Tensor, normals: torch.Tensor,
                sigma: float) -> torch.Tensor:
    """SmoothGrad from standard normals [samples, *wav.shape]."""
    span = wav.max() - wav.min()
    total = torch.zeros_like(wav)
    for n in normals:
        total = total + _grad(score_fn, wav + n * sigma * span)
    return total / normals.shape[0]


def smoothgrad(score_fn: ScoreFn, wav: torch.Tensor, generator: torch.Generator | None = None,
               samples: int = 16, sigma: float = 0.1) -> torch.Tensor:
    """sigma is relative to the batch's dynamic range max(wav) - min(wav)."""
    normals = torch.randn((samples, *wav.shape), generator=generator, dtype=wav.dtype,
                          device=wav.device)
    return _smoothgrad(score_fn, wav, normals, sigma)


def _gradient_shap(score_fn: ScoreFn, wav: torch.Tensor, baselines: torch.Tensor,
                   index: torch.Tensor, u: torch.Tensor, normals: torch.Tensor,
                   sigma: float) -> torch.Tensor:
    """GradientShap from the draws: baseline indices [samples, B], u
    [samples, B, 1, ...] in [0, 1), standard normals [samples, *wav.shape]."""
    span = wav.max() - wav.min()
    total = torch.zeros_like(wav)
    for idx, u_k, n in zip(index, u, normals):
        base = baselines[idx]
        point = base + u_k * (wav - base) + n * sigma * span
        total = total + (wav - base) * _grad(score_fn, point)
    return total / normals.shape[0]


def gradient_shap(score_fn: ScoreFn, wav: torch.Tensor, generator: torch.Generator | None = None,
                  baselines: torch.Tensor | None = None, samples: int = 16,
                  sigma: float = 0.1) -> torch.Tensor:
    """`baselines` [n, *wav.shape[1:]] (two silent clips by default)."""
    if baselines is None:
        baselines = torch.zeros((2, *wav.shape[1:]), dtype=wav.dtype, device=wav.device)
    b, kw = wav.shape[0], dict(generator=generator, device=wav.device)
    index = torch.randint(0, baselines.shape[0], (samples, b), **kw)
    u = torch.rand((samples, b) + (1,) * (wav.ndim - 1), dtype=wav.dtype, **kw)
    normals = torch.randn((samples, *wav.shape), dtype=wav.dtype, **kw)
    return _gradient_shap(score_fn, wav, baselines, index, u, normals, sigma)


def attribution_mask(attr: torch.Tensor) -> torch.Tensor:
    """|attr| normalised to [0, 1] per example."""
    a = attr.abs()
    peak = a.amax(dim=tuple(range(1, a.ndim)), keepdim=True)
    return a / (peak + 1e-8)


METHODS = {
    "saliency": saliency,
    "input_x_gradient": input_x_gradient,
    "integrated_gradients": integrated_gradients,
    "smoothgrad": smoothgrad,
    "gradient_shap": gradient_shap,
}
RANDOM_METHODS = ("smoothgrad", "gradient_shap")


def waveform_explanation(score_fn: ScoreFn, wav: torch.Tensor, method: str = "input_x_gradient",
                         generator: torch.Generator | None = None, **kw):
    """-> (mask, relevant_wav, irrelevant_wav): the waveform-domain masking
    protocol, wav * mask and wav * (1 - mask). The random methods draw from
    `generator`, or from a fresh one seeded 0 (the JAX package's default key
    is PRNGKey(0) at every call)."""
    fn = METHODS[method]
    if method in RANDOM_METHODS:
        if generator is None:
            generator = torch.Generator(device=wav.device).manual_seed(0)
        attr = fn(score_fn, wav, generator, **kw)
    else:
        attr = fn(score_fn, wav, **kw)
    mask = attribution_mask(attr)
    return mask, wav * mask, wav * (1.0 - mask)
