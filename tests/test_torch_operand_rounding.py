"""PyTorch port: `closed_loop_protocol.py`'s detector fit at a TPU's default
matmul precision, held against the same arithmetic written in JAX.

On a TPU, JAX's default precision takes an f32 `dot` with both operands
rounded to bf16 and the products summed in f32. `round_bf16`,
`Bf16OperandProduct` and `bf16_operand_objective` reproduce that for the
detector's objective (the logit's product and its gradient's); the JAX
reference here is written with `jax.custom_vjp` over `lax.dot_general` of
bf16 operands with `preferred_element_type=float32`, no private JAX
function patched.

Bars:
- the rounding bit for bit, NaN included;
- the objective's value and gradient: a product of two bf16 values is exact
  in f32, so the two sides differ by f32 summation order alone, bounded by
  n u sum|terms| (u = 2^-24, n the longest chain of additions: D products a
  logit, N rows a sum; the terms the products and the rows' losses);
- a 50-step L-BFGS fit (the port's `lbfgs_fit` against `optax.lbfgs()`
  driven as the JAX package's fit drives it) within twice JAX's own spread
  when every element of its input moves one ulp, as
  tests/test_torch_detector_stage.py holds its fit. The objective reads x
  only through its bf16 rounding, which absorbs a one-f32-ulp move, so the
  ulp is bf16's: every element of round(x) moved one bf16 step
  (`chip_smoke.bf16_step_moved`, as check (ii)'s per-draw bar moves the
  bf16 UNet's input);
- the package's own `fit_logreg` bit-identical with the script imported.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax

import closed_loop_protocol as clp
from chip_smoke import bf16_step_moved
from xai_audio_deepfakes_tpu_torch.train import closed_loop as tcl
from xai_audio_deepfakes_tpu_torch.train import train_logreg as ttl

C = 1e6
N, D = 48, 128
FIT_STEPS, SPREAD_DRAWS, SPREAD_MARGIN = 50, 2, 2.0
U32 = 2.0**-24


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Fits on several xdist workers: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def corpus(seed: int = 0):
    """A separable corpus with offset features, fewer rows than features:
    the protocol's regime at tiny size."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((N, D)) + 0.5).astype(np.float32)
    s = x @ rng.standard_normal(D)
    return x, (s > np.median(s)).astype(np.float32)


def bf16_bits(a: np.ndarray) -> np.ndarray:
    """JAX's f32 -> bf16 conversion, as the f32 bit patterns of the result."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)).view(np.uint32)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


@jax.custom_vjp
def bf16_dot(x, w):
    return lax.dot_general(x.astype(jnp.bfloat16), w.astype(jnp.bfloat16), (((1,), (0,)), ((), ())),
                           preferred_element_type=jnp.float32)


def _bf16_dot_fwd(x, w):
    return bf16_dot(x, w), x


def _bf16_dot_bwd(x, g):
    dw = lax.dot_general(x.astype(jnp.bfloat16), g.astype(jnp.bfloat16), (((0,), (0,)), ((), ())),
                         preferred_element_type=jnp.float32)
    return jnp.zeros_like(x), dw


bf16_dot.defvjp(_bf16_dot_fwd, _bf16_dot_bwd)


def jax_objective(params, x, y):
    z = bf16_dot(x, params["weight"]) + params["bias"]
    nll = jnp.sum(y * jax.nn.softplus(-z) + (1.0 - y) * jax.nn.softplus(z))
    return nll + 0.5 / C * jnp.sum(params["weight"] ** 2)


SOLVER = optax.lbfgs()


@jax.jit
def _jax_step(params, opt_state, x, y):
    def objective(p):
        return jax_objective(p, x, y)

    value, grad = optax.value_and_grad_from_state(objective)(params, state=opt_state)
    updates, opt_state = SOLVER.update(grad, opt_state, params, value=value, grad=grad,
                                       value_fn=objective)
    return optax.apply_updates(params, updates), opt_state, value, optax.global_norm(grad)


def jax_fit(x: np.ndarray, y: np.ndarray, max_iter: int = FIT_STEPS, tol: float = 1e-7) -> dict:
    """`optax.lbfgs()` on `jax_objective`, driven as the JAX package's
    `fit_logreg` drives it."""
    xj, yj = jnp.asarray(x), jnp.asarray(y)[:, None]
    params = {"weight": jnp.zeros((x.shape[1], 1), jnp.float32),
              "bias": jnp.zeros((1,), jnp.float32)}
    opt_state = SOLVER.init(params)
    for _ in range(max_iter):
        params, opt_state, value, gnorm = _jax_step(params, opt_state, xj, yj)
        if float(gnorm) < tol * max(1.0, float(jnp.abs(value))):
            break
    return {k: np.asarray(v) for k, v in params.items()}


# ---------------------------------------------------------------------------
# the rounding
# ---------------------------------------------------------------------------


def rounding_cases() -> dict:
    rng = np.random.default_rng(1)
    scale = np.float32(10.0) ** rng.integers(-30, 31, 4096).astype(np.float32)
    ties = ((rng.integers(0, 2**16, 4096).astype(np.uint32) << 16) | 0x8000).view(np.float32)
    sub = rng.integers(1, 2**23, 1024).astype(np.uint32).view(np.float32)
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FC00001, 0xFFC12345, 0x7FBFFFFF],
                    np.uint32).view(np.float32)
    return {"random": (rng.standard_normal(4096) * scale).astype(np.float32),
            "ties": ties, "subnormals": np.concatenate([sub, -sub]),
            "specials": np.array([np.inf, -np.inf, 0.0, -0.0, np.finfo(np.float32).max,
                                  -np.finfo(np.float32).max, np.finfo(np.float32).tiny], np.float32),
            "nan": nans}


@pytest.mark.parametrize("case", ["random", "ties", "subnormals", "specials", "nan"])
def test_round_bf16_is_jax_cast(case):
    x = rounding_cases()[case]
    got = clp.round_bf16(torch.from_numpy(x)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, bf16_bits(x))


# ---------------------------------------------------------------------------
# the objective
# ---------------------------------------------------------------------------


def test_objective_value_and_gradient_match_jax():
    x, y = corpus()
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((D, 1)) * 0.3).astype(np.float32)
    b = np.float32([0.7])
    params = {"weight": torch.tensor(w, requires_grad=True),
              "bias": torch.tensor(b, requires_grad=True)}
    value = clp.bf16_operand_objective(params, torch.from_numpy(x), torch.from_numpy(y)[:, None], C)
    gw, gb = torch.autograd.grad(value, [params["weight"], params["bias"]])
    value = value.detach()
    jv, jg = jax.value_and_grad(jax_objective)({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                                               jnp.asarray(x), jnp.asarray(y)[:, None])

    # the terms of every sum, in float64 from the same rounded operands
    xr, wr = bf16_bits(x).view(np.float32).astype(np.float64), bf16_bits(w).view(np.float32)
    z = xr @ wr.astype(np.float64) + b[0]
    rows = y * np.logaddexp(0.0, -z[:, 0]) + (1.0 - y) * np.logaddexp(0.0, z[:, 0])
    s_products = float(np.abs(xr * wr[:, 0]).sum())
    s_rows = float(np.abs(rows).sum() + 0.5 / C * (w.astype(np.float64) ** 2).sum())
    bar = (D + N) * U32 * (s_products + s_rows)
    assert abs(float(value) - float(jv)) <= bar, (float(value), float(jv), bar)

    g = 1.0 / (1.0 + np.exp(-z[:, 0])) - y  # dL/dz
    gr = bf16_bits(g.astype(np.float32)).view(np.float32).astype(np.float64)
    bar_w = N * U32 * (np.abs(xr * gr[:, None]).sum(axis=0) + np.abs(w[:, 0]) / C)
    bar_b = (N + 4) * U32 * np.abs(g).sum()
    err_w = np.abs(gw.numpy()[:, 0] - np.asarray(jg["weight"])[:, 0])
    assert (err_w <= bar_w).all(), (err_w.max(), bar_w.min())
    assert abs(float(gb[0]) - float(jg["bias"][0])) <= bar_b
    # the weight's gradient takes bf16 operands: against the unrounded
    # product it is off by far more than the bar
    assert np.abs(gw.numpy()[:, 0] - x.T.astype(np.float64) @ g).max() > bar_w.max()


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------


def measures(x: np.ndarray, y: np.ndarray, ref: dict, head: dict) -> dict:
    """How far `head` is from `ref` on (x, y): 1 - cosine of the weights, and
    |w|, the median |logit| and the rounded objective in float64, relative."""
    xr = bf16_bits(x).view(np.float32).astype(np.float64)

    def summary(h):
        w = np.asarray(h["weight"], np.float64)[:, 0]
        wr = bf16_bits(np.asarray(h["weight"], np.float32)).view(np.float32)[:, 0].astype(np.float64)
        z = xr @ wr + float(np.asarray(h["bias"])[0])
        obj = np.sum(y * np.logaddexp(0.0, -z) + (1.0 - y) * np.logaddexp(0.0, z)) + 0.5 / C * w @ w
        return w, float(np.linalg.norm(w)), float(np.median(np.abs(z))), float(obj)

    w0, n0, m0, o0 = summary(ref)
    w1, n1, m1, o1 = summary(head)
    return {"one_minus_cosine": 1.0 - float(w0 @ w1 / (n0 * n1)), "w_norm_rel": abs(n1 / n0 - 1.0),
            "median_abs_logit_rel": abs(m1 / m0 - 1.0), "objective_rel": abs(o1 - o0) / o0}


def test_fit_matches_optax_within_jax_spread():
    x, y = corpus()
    head = clp.fit_bf16_operands(x, y, max_iter=FIT_STEPS, device="cpu")
    ref = jax_fit(x, y)
    dev = measures(x, y, ref, head)
    moved = [bf16_step_moved(torch.from_numpy(x), seed).numpy() for seed in range(SPREAD_DRAWS)]
    spread = [measures(x, y, ref, jax_fit(xm, y)) for xm in moved]
    bar = {k: SPREAD_MARGIN * max(s[k] for s in spread) for k in dev}
    assert all(dev[k] <= bar[k] for k in dev), (dev, bar)
    # the fit moved: the training rows separated
    z = x @ head["weight"].numpy()[:, 0] + float(head["bias"][0])
    assert ((z > 0) == (y > 0.5)).all()


def test_train_detector_bf16_operands_keeps_split_and_evaluation(monkeypatch):
    """The rounded fit behind the package's split and evaluation (the fit
    itself stubbed: `test_fit_matches_optax_within_jax_spread` holds it)."""
    x, y = corpus(3)
    seen, logs = [], []

    def fit(x_tr, y_tr, c, device, log_fn):
        seen.append((x_tr, y_tr, c, device))
        log_fn({"lbfgs": {}})
        w = torch.from_numpy(np.linalg.lstsq(x_tr, 2.0 * y_tr - 1.0, rcond=None)[0][:, None])
        return {"weight": w.float(), "bias": torch.zeros(1)}

    monkeypatch.setattr(clp, "fit_bf16_operands", fit)
    params, metrics = clp.train_detector_bf16_operands(x, y, log_fn=logs.append, device="cpu")
    x_tr, x_te, y_tr, y_te = ttl.stratified_split(x, y)
    (sx, sy, c, device), = seen
    assert np.array_equal(sx, x_tr) and np.array_equal(sy, y_tr) and (c, device) == (C, "cpu")
    assert metrics == ttl.evaluate_logreg(params, x_te, y_te)
    assert [next(iter(r)) for r in logs] == ["lbfgs", "detector"]


FIT_ALONE = """
import sys
import numpy as np, torch
torch.set_num_threads(1)
from xai_audio_deepfakes_tpu_torch.train import train_logreg
d = np.load(sys.argv[1])
p = train_logreg.fit_logreg(d["x"], d["y"], device="cpu")
print(p["weight"].numpy().tobytes().hex(), p["bias"].numpy().tobytes().hex())
"""


def test_default_fit_unchanged_by_the_script(tmp_path):
    """The script's rounded fit is opt-in: with it imported (and run) the
    package's `fit_logreg` and `closed_loop.train_detector` are untouched and
    the fit is bit-identical to a process that never imported it."""
    x, y = corpus(4)
    np.savez(tmp_path / "corpus.npz", x=x, y=y)
    clp.fit_bf16_operands(x, y, max_iter=3, device="cpu")
    assert tcl.train_detector is ttl.train_detector
    p = ttl.fit_logreg(x, y, device="cpu")
    alone = subprocess.run([sys.executable, "-c", FIT_ALONE, str(tmp_path / "corpus.npz")],
                           capture_output=True, text=True, check=True,
                           cwd=Path(__file__).resolve().parents[1]).stdout.split()
    assert [p["weight"].numpy().tobytes().hex(), p["bias"].numpy().tobytes().hex()] == alone
