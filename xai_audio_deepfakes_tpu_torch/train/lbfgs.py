"""Full-batch L-BFGS with a zoom line search: `optax.lbfgs()` written in
PyTorch.

The JAX package fits its detector head and its band probe with
`optax.lbfgs()` and `optax.value_and_grad_from_state`. This is that
algorithm step for step (optax 0.2.6: `scale_by_lbfgs`, `zoom_linesearch`,
`scale_by_zoom_linesearch` with `lbfgs`' defaults):

* a memory of 10 (s, y) pairs, each weighted 1/<s, y> (0 where <s, y> is
  0; no pair is skipped for small curvature), the identity scaled by
  <s, y> / <y, y> of the newest pair, and on the very first step by
  min(1, 1 / ||g||), then the two-loop recursion;
* the zoom line search (Nocedal and Wright, algorithms 3.5 and 3.6, with
  Hager and Zhang's approximate decrease): initial guess 1, slope_rtol
  1e-4, curv_rtol 0.9, approx_dec_rtol 1e-6, increase factor 2, stepsize
  precision 1e-5, at most 20 steps; a failed search falls back to the best
  point of sufficient decrease, else keeps its last point, as optax does;
* the value and gradient at the accepted point carried into the next step.

Vectors stay in the parameters' dtype on their device. The line search's
scalars are 0-d tensors of that dtype on the host, synced once an
evaluation, because its branches decide which point is evaluated next.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
STEPSIZE_PRECISION = 1e-5

ValueAndGrad = Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a; NaN where it has none (optax's `_cubicmin`)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    e1 = fb - fa - C * db
    e2 = fc - fa - C * dc
    A = (dc**2 * e1 + -(db**2) * e2) / denom
    B = (-(dc**3) * e1 + db**3 * e2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a (optax's `_quadmin`)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db**2)
    return a - fpa / (2.0 * B)


def _violation(err):
    """Only a violation counts; NaN counts as infinite."""
    err = torch.maximum(err, torch.zeros_like(err))
    return torch.where(torch.isnan(err), torch.full_like(err, math.inf), err)


class _Point:
    """A point on the search line: stepsize, value, gradient, slope."""

    __slots__ = ("stepsize", "value", "grad", "slope")

    def __init__(self, stepsize, value, grad, slope):
        self.stepsize, self.value, self.grad, self.slope = stepsize, value, grad, slope


def zoom_linesearch(evaluate: Callable, start: _Point, guess):
    """optax's `zoom_linesearch` with `lbfgs`' settings along one direction.
    `evaluate(stepsize)` -> the _Point there; `start` is the point at
    stepsize 0. -> the accepted _Point."""
    value_init, slope_init = start.value, start.slope

    def errors(p: _Point):
        dec = p.value - value_init - SLOPE_RTOL * p.stepsize * slope_init
        approx = p.slope - (2 * SLOPE_RTOL - 1.0) * slope_init
        delta = p.value - value_init - APPROX_DEC_RTOL * torch.abs(value_init)
        dec = _violation(torch.minimum(torch.maximum(approx, delta), dec))
        curv = _violation(torch.abs(p.slope) - CURV_RTOL * torch.abs(slope_init))
        return dec, curv

    cur = start
    low = high = cubic_ref = start
    safe = _Point(torch.zeros_like(value_init), start.value, start.grad, start.slope)
    dec_err = torch.full_like(value_init, math.inf)
    interval_found = done = failed = False
    count = 0
    while not (done or failed):
        if not interval_found:  # algorithm 3.5: grow the step until it brackets
            stepsize = guess if count == 0 else INCREASE_FACTOR * cur.stepsize
            new = evaluate(stepsize)
            dec_err, curv_err = errors(new)
            if bool(dec_err <= 0.0):
                safe = new
            set_high = bool(dec_err > 0.0) or (count > 0 and bool(new.value >= cur.value))
            set_low = not set_high and bool(new.slope >= 0.0)
            low, high = (new, cur) if set_low else (cur, new)
            cubic_ref = low
            new_err_ok = bool(torch.maximum(dec_err, curv_err) <= 0.0)
            interval_found = set_high or set_low or new_err_ok
            done = new_err_ok
            failed = count + 1 >= MAX_LINESEARCH_STEPS and not done
        else:  # algorithm 3.6: zoom into [low, high]
            delta = torch.abs(high.stepsize - low.stepsize)
            left = torch.minimum(high.stepsize, low.stepsize)
            right = torch.maximum(high.stepsize, low.stepsize)
            middle_cubic = _cubicmin(low.stepsize, low.value, low.slope, high.stepsize,
                                     high.value, cubic_ref.stepsize, cubic_ref.value)
            middle_quad = _quadmin(low.stepsize, low.value, low.slope, high.stepsize, high.value)
            if bool((middle_cubic > left + 0.2 * delta) & (middle_cubic < right - 0.2 * delta)):
                middle = middle_cubic
            elif bool((middle_quad > left + 0.1 * delta) & (middle_quad < right - 0.1 * delta)):
                middle = middle_quad
            else:
                middle = (low.stepsize + high.stepsize) / 2.0
            new = evaluate(middle)
            dec_err, curv_err = errors(new)
            if bool(dec_err <= 0.0) and bool(new.value < safe.value):
                safe = new
            done = bool(torch.maximum(dec_err, curv_err) <= 0.0)
            set_high_to_middle = bool(dec_err > 0.0) or bool(new.value >= low.value)
            set_high_to_low = (not set_high_to_middle
                               and bool(new.slope * (high.stepsize - low.stepsize) >= 0.0))
            cubic_ref = high if set_high_to_middle or set_high_to_low else low
            if set_high_to_middle:
                high = new
            elif set_high_to_low:
                high, low = low, new
            else:
                low = new
            too_small = bool(delta <= STEPSIZE_PRECISION)
            failed = not done and (count + 1 >= MAX_LINESEARCH_STEPS
                                   or (too_small and bool(safe.stepsize > 0.0)))
        cur = new
        count += 1
        if failed and (bool(safe.stepsize > 0.0) or bool(torch.isinf(dec_err))):
            cur = safe
    return cur


class LBFGS:
    """optax.lbfgs() over a flat parameter vector.

    `value_and_grad(x)` -> (objective, gradient) at x, both on x's device
    in x's dtype. Each `step()` takes one L-BFGS step from the current
    iterate `x` and returns the objective and gradient norm at the step's
    start, as the JAX package's fits read them for their stop rule."""

    def __init__(self, value_and_grad: ValueAndGrad, x0: torch.Tensor):
        self.fn = value_and_grad
        self.x = x0.detach().clone()
        self.dtype = self.x.dtype
        n = self.x.numel()
        self.s_mem = self.x.new_zeros((MEMORY_SIZE, n))
        self.y_mem = self.x.new_zeros((MEMORY_SIZE, n))
        self.rho = self.x.new_zeros((MEMORY_SIZE,))
        self.count = 0
        self.evaluations = 0
        self.prev_x = self.prev_grad = None
        self.value = torch.tensor(math.inf, dtype=self.dtype)  # host scalar
        self.grad = None

    def _value_and_grad(self, x):
        self.evaluations += 1
        value, grad = self.fn(x)
        return value.detach().reshape(()), grad.detach().reshape(-1)

    def _direction(self, grad: torch.Tensor) -> torch.Tensor:
        """scale_by_lbfgs: push the newest pair, scale the identity, two loops."""
        m = MEMORY_SIZE
        if self.count > 0:
            s = self.x - self.prev_x
            y = grad - self.prev_grad
            sy = torch.dot(y, s)
            slot = (self.count - 1) % m
            self.s_mem[slot], self.y_mem[slot] = s, y
            self.rho[slot] = torch.where(sy == 0.0, torch.zeros_like(sy), 1.0 / sy)
            yy = torch.dot(y, y)
            gamma = torch.where(yy > 0.0, sy / yy, torch.ones_like(sy))
        else:
            gamma = torch.minimum(torch.ones((), dtype=self.dtype, device=grad.device),
                                  1.0 / torch.linalg.vector_norm(grad))
        order = [(self.count + i) % m for i in range(m)]
        q = grad
        alphas = {}
        for i in reversed(order):  # newest pair first
            alphas[i] = self.rho[i] * torch.dot(self.s_mem[i], q)
            q = q - alphas[i] * self.y_mem[i]
        q = gamma * q
        for i in order:
            beta = self.rho[i] * torch.dot(self.y_mem[i], q)
            q = q + (alphas[i] - beta) * self.s_mem[i]
        self.prev_x, self.prev_grad = self.x, grad
        self.count += 1
        return -1.0 * q

    def step(self) -> tuple[float, float]:
        if not bool(torch.isfinite(self.value)):  # value_and_grad_from_state
            value, self.grad = self._value_and_grad(self.x)
            self.value = value.cpu().to(self.dtype)
        value, grad = self.value, self.grad
        direction = self._direction(grad)
        gnorm, slope = torch.stack([torch.linalg.vector_norm(grad),
                                    torch.dot(direction, grad)]).cpu()
        x = self.x

        def evaluate(stepsize) -> _Point:
            v, g = self._value_and_grad(x + stepsize.item() * direction)
            v, sl = torch.stack([v.to(self.dtype), torch.dot(g, direction)]).cpu()
            return _Point(stepsize, v, g, sl)

        guess = torch.ones((), dtype=self.dtype)
        end = zoom_linesearch(evaluate, _Point(torch.zeros_like(value), value, grad, slope), guess)
        self.x = x + end.stepsize.item() * direction
        self.value, self.grad = end.value, end.grad
        return float(value), float(gnorm)

