"""PyTorch port, `train/lbfgs.py`: optax.lbfgs() written in PyTorch, held
against optax iterate by iterate in float64, and the detector's and the
band probe's fits against the JAX package's where features outnumber rows.

Bars: in float64 the first 30 iterates within 1e-8 relative (||dx|| /
||x||) of optax's (on these draws a one-ulp float64 nudge of the input
moves optax's own first 30 by up to 1.3e-12, and the port's lie within
1.1e-12 of optax's; in f32 the line search's choices flip with the last
bit, so iterates are compared in float64 only); the line search's
interpolants within 1e-12; the f32 fits against JAX's at objective 1e-4
relative, weight cosine above 0.9999, |w| and the median |logit| within
0.5%; the port's own fit run to convergence within 1e-6 relative of
scipy's float64 optimum.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.optimize
import torch

from xai_audio_deepfakes_tpu.train import band_probe as jbp
from xai_audio_deepfakes_tpu.train import train_logreg as jtl
from xai_audio_deepfakes_tpu_torch.train import band_probe as tbp
from xai_audio_deepfakes_tpu_torch.train import lbfgs as tlb
from xai_audio_deepfakes_tpu_torch.train import train_logreg as ttl

C = 1e6
SHAPES = [(96, 256), (160, 512)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Gradients on several xdist workers: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def offset_features(n: int, d: int, seed: int):
    """x = 0.1 N(0, 1) + U(1, 3): a common offset per feature, as pooled
    embeddings have; labels from a linear rule on the centred features
    plus 0.3 logistic noise."""
    rng = np.random.default_rng(seed)
    sig = rng.standard_normal((n, d))
    w = rng.standard_normal(d)
    x = (0.1 * sig + rng.uniform(1.0, 3.0, d)).astype(np.float32)
    z = (x - x.mean(axis=0)) @ w + 0.3 * rng.logistic(size=n)
    return x, (z > 0).astype(np.int64)


def objective64(w, b, x, y):
    """sklearn's objective in float64 at (w, b) -> (value, logits)."""
    z = x.astype(np.float64) @ w + b
    return float(np.sum(np.logaddexp(0.0, z) - z * y) + 0.5 / C * w @ w), z


def optimum64(x, y):
    """scipy's L-BFGS-B in float64 to its precision -> (value, w, b)."""
    xd, d = x.astype(np.float64), x.shape[1]

    def f(v):
        val, z = objective64(v[:d], v[d], x, y)
        r = 0.5 * (1.0 + np.tanh(0.5 * z)) - y  # sigmoid(z) - y without overflow
        return val, np.concatenate([xd.T @ r + v[:d] / C, [r.sum()]])

    res = scipy.optimize.minimize(f, np.zeros(d + 1), jac=True, method="L-BFGS-B",
                                  options={"maxiter": 50000, "ftol": 1e-15, "gtol": 1e-12})
    return res.fun, res.x[:d], res.x[d]


def _cos(a, b) -> float:
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# ---------------------------------------------------------------------------
# iterates against optax in float64
# ---------------------------------------------------------------------------


def optax_iterates(fun, x0: np.ndarray, k: int) -> list:
    """optax.lbfgs() driven as the JAX package's fits drive it, in float64."""
    with jax.enable_x64(True):
        solver = optax.lbfgs()
        vg = optax.value_and_grad_from_state(fun)

        @jax.jit
        def step(p, st):
            v, g = vg(p, state=st)
            u, st = solver.update(g, st, p, value=v, grad=g, value_fn=fun)
            return optax.apply_updates(p, u), st

        p = jnp.asarray(x0, jnp.float64)
        st = solver.init(p)
        out = []
        for _ in range(k):
            p, st = step(p, st)
            out.append(np.asarray(p))
    return out


def port_iterates(fun, x0: np.ndarray, k: int) -> list:
    def vg(x):
        x = x.detach().requires_grad_(True)
        v = fun(x)
        return v, torch.autograd.grad(v, x)[0]

    opt = tlb.LBFGS(vg, torch.from_numpy(np.asarray(x0, np.float64)))
    out = []
    for _ in range(k):
        opt.step()
        out.append(opt.x.numpy())
    return out


def _logistic_pair(x, y):
    """One objective in both frameworks: logaddexp(z, 0) - y z (JAX's
    softplus; torch's `F.softplus` returns z itself beyond z = 20), whose
    gradient is sigmoid(z) - y in both (no kink at z = 0)."""
    d = x.shape[1]
    xj, yj = jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64)
    xt, yt = torch.from_numpy(x.astype(np.float64)), torch.from_numpy(y.astype(np.float64))

    def fj(p):
        z = xj @ p[:d] + p[d]
        return jnp.sum(jax.nn.softplus(z) - z * yj) + 0.5 / C * jnp.sum(p[:d] ** 2)

    def ft(p):
        z = xt @ p[:d] + p[d]
        return (torch.logaddexp(z, torch.zeros_like(z)) - z * yt).sum() + 0.5 / C * (p[:d] ** 2).sum()

    return fj, ft, np.zeros(d + 1)


@pytest.mark.parametrize("n,d", SHAPES)
def test_iterates_match_optax_float64(n, d):
    """The logistic objective at C = 1e6 on offset features, more features
    than rows: the port's first 30 iterates within 1e-8 of optax's."""
    with jax.enable_x64(True):
        fj, ft, x0 = _logistic_pair(*offset_features(n, d, seed=0))
        want = optax_iterates(fj, x0, 30)
    got = port_iterates(ft, x0, 30)
    for k, (a, b) in enumerate(zip(got, want), 1):
        assert np.linalg.norm(a - b) <= 1e-8 * np.linalg.norm(b), k


def _rosenbrock(p):
    return (1 - p[0]) ** 2 + 100 * (p[1] - p[0] ** 2) ** 2


@pytest.mark.parametrize("case", ["rosenbrock", "unbounded", "barrier"])
def test_line_search_paths_match_optax_float64(case):
    """Objectives that take the line search down its other paths: the
    zoom's cubic and quadratic steps (Rosenbrock from (0, 0), to its
    minimum), a search
    that never meets the curvature condition and fails onto its safe point
    (a linear objective, unbounded below), and trial points outside the
    domain, where the value is NaN (-log(1 - x) - 3x from x = 0.5)."""
    if case == "rosenbrock":
        fj, ft, x0, k = _rosenbrock, _rosenbrock, np.zeros(2), 20
    elif case == "unbounded":
        fj = lambda p: -jnp.sum(p * jnp.arange(1.0, 4.0))  # noqa: E731
        ft = lambda p: -(p * torch.arange(1.0, 4.0, dtype=p.dtype)).sum()  # noqa: E731
        x0, k = np.zeros(3), 4
    else:
        fj = lambda p: jnp.sum(-jnp.log(1 - p) - 3 * p)  # noqa: E731
        ft = lambda p: (-torch.log(1 - p) - 3 * p).sum()  # noqa: E731
        x0, k = np.array([0.5, 0.2, -0.4]), 12
    want = optax_iterates(fj, x0, k)
    got = port_iterates(ft, x0, k)
    for i, (a, b) in enumerate(zip(got, want), 1):
        assert np.linalg.norm(a - b) <= 1e-8 * np.linalg.norm(b), (i, a, b)


def test_interpolants_match_optax():
    """The zoom's cubic and quadratic minimisers, NaN where they have none."""
    from optax._src import linesearch as ols

    rng = np.random.default_rng(3)
    with jax.enable_x64(True):
        for row in rng.standard_normal((50, 7)):
            row[5] = row[0] if row[6] > 1.0 else row[5]  # c = a: no cubic
            a, fa, fpa, b, fb, c, fc = row
            t = [torch.tensor(v, dtype=torch.float64) for v in row]
            want = float(ols._cubicmin(a, fa, fpa, b, fb, c, fc))
            got = float(tlb._cubicmin(*t))
            assert (np.isnan(got) and np.isnan(want)) or got == pytest.approx(want, rel=1e-12)
            want = float(ols._quadmin(a, fa, fpa, b, fb))
            assert float(tlb._quadmin(*t[:5])) == pytest.approx(want, rel=1e-12)


def test_lbfgs_follows_the_parameters_dtype():
    """Vectors and the line search's scalars in the parameters' dtype."""
    for dtype in (torch.float32, torch.float64):
        def vg(x):
            return (x * x).sum(), 2 * x

        opt = tlb.LBFGS(vg, torch.tensor([3.0, -4.0], dtype=dtype))
        value, gnorm = opt.step()
        assert (value, gnorm) == (25.0, 10.0)
        assert opt.x.dtype == dtype and opt.value.dtype == dtype and opt.grad.dtype == dtype
        opt.step()
        assert float(opt.x.abs().max()) < 1e-6


# ---------------------------------------------------------------------------
# the fits against the JAX package's, more features than rows
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_fits():
    """JAX's fit_logreg (1000 steps, tol 1e-7) and scipy's float64 optimum
    on the draw of each shape. JAX's f32 gradient cancels as
    binary_cross_entropy_with_logits' does (sigmoid(z) - y at |z| of
    10-20: relative error 1.9 at 96 x 256's optimum, 0.06 in
    `logreg_objective`'s form), so on many draws its fit stops above the
    optimum (5.6e-5 to 1.7e-2 after 1000 steps on seeds 0-3, `python -m
    tests.test_torch_lbfgs`); seed 2 is the one of the four where it ends
    within 2e-4 at both shapes, which
    `test_fit_logreg_matches_jax_more_features_than_rows` checks first."""
    out = {}
    for n, d in SHAPES:
        x, y = offset_features(n, d, seed=2)
        p = jtl.fit_logreg(x, y, c=C)
        out[n, d] = (x, y, np.asarray(p["weight"])[:, 0], float(np.asarray(p["bias"])[0]),
                     optimum64(x, y))
    return out


@pytest.mark.parametrize("n,d", SHAPES)
def test_fit_logreg_matches_jax_more_features_than_rows(jax_fits, n, d):
    """The port's fit_logreg against JAX's at C = 1e6: objective within
    1e-4 relative, weight cosine above 0.9999, |w| and the median |logit|
    on the training rows within 0.5%. (The parent's torch L-BFGS: cosine
    0.9785 / 0.9034 to JAX's fit, 1.07x / 2.96x the optimum's objective.)"""
    x, y, wj, bj, (best, _, _) = jax_fits[n, d]
    oj, zj = objective64(wj, bj, x, y)
    assert oj - best <= 2e-4 * best, "JAX's own fit stopped short of the optimum"
    logs = []
    p = ttl.fit_logreg(x, y, c=C, device="cpu", log_fn=logs.append)
    assert logs[0]["lbfgs"]["steps"] == 1000 or logs[0]["lbfgs"]["gnorm"] < 1e-7
    w, b = p["weight"].numpy()[:, 0].astype(np.float64), float(p["bias"][0])
    o, z = objective64(w, b, x, y)
    assert abs(o - oj) <= 1e-4 * oj, (o, oj)
    assert _cos(w, wj) > 0.9999
    assert np.linalg.norm(w) == pytest.approx(np.linalg.norm(wj), rel=5e-3)
    assert np.median(np.abs(z)) == pytest.approx(np.median(np.abs(zj)), rel=5e-3)


@pytest.mark.parametrize("n,d", SHAPES)
def test_fit_logreg_reaches_the_optimum(n, d):
    """Run to convergence (tol 1e-9, 2000 steps) on a draw where JAX's f32
    fit stalls at 160 x 512 (3.5e-3 above the optimum after 3000 steps):
    the port's fit within 1e-6 relative of scipy's float64 optimum, cosine
    above 0.99999."""
    x, y = offset_features(n, d, seed=0)
    best, w_best, _ = optimum64(x, y)
    p = ttl.fit_logreg(x, y, c=C, max_iter=2000, tol=1e-9, device="cpu")
    w = p["weight"].numpy()[:, 0].astype(np.float64)
    o, _ = objective64(w, float(p["bias"][0]), x, y)
    assert o - best <= 1e-6 * best, (o, best)
    assert _cos(w, w_best) > 0.99999


def test_fit_softmax_probe_matches_jax_more_features_than_rows():
    """The band probe's fit at 96 rows x 256 features, 4 classes, l2 1e-2,
    both run to their stop rule (2000 steps at most): objective within 1e-4
    relative, weight cosine above 0.9999, |W| and the median |logit|
    (centred over the classes: the bias is free up to a constant) within
    0.5% of JAX's."""
    rng = np.random.default_rng(0)
    n, d, k, l2 = 96, 256, 4, 1e-2
    sig = rng.standard_normal((n, d))
    x = (0.1 * sig + rng.uniform(1.0, 3.0, d)).astype(np.float32)
    y = np.argmax(sig @ rng.standard_normal((d, k)) / np.sqrt(d)
                  + 0.3 * rng.gumbel(size=(n, k)), axis=1)
    want = jbp.fit_softmax_probe(x, y, k, l2=l2, max_iter=2000)
    got = tbp.fit_softmax_probe(x, y, k, l2=l2, max_iter=2000, device="cpu")

    def stats(p):
        z = x.astype(np.float64) @ p["weight"] + p["bias"]
        zc = z - z.max(axis=1, keepdims=True)
        nll = -(zc[np.arange(n), y] - np.log(np.exp(zc).sum(axis=1))).sum()
        value = nll + 0.5 * l2 * (p["weight"].astype(np.float64) ** 2).sum()
        return value, np.median(np.abs(z - z.mean(axis=1, keepdims=True)))

    (o, med), (oj, medj) = stats(got), stats(want)
    assert abs(o - oj) <= 1e-4 * oj
    assert _cos(got["weight"], want["weight"]) > 0.9999
    assert np.linalg.norm(got["weight"]) == pytest.approx(np.linalg.norm(want["weight"]),
                                                          rel=5e-3)
    assert med == pytest.approx(medj, rel=5e-3)


def test_port_imports_no_optax_or_torch_lbfgs():
    """The L-BFGS is the port's own: no module imports optax or uses
    torch's L-BFGS."""
    root = Path(__file__).resolve().parents[1] / "xai_audio_deepfakes_tpu_torch"
    for path in root.rglob("*.py"):
        src = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+optax", src, re.M), path
        assert not re.search(r"optim\s*\.\s*LBFGS|^\s*from\s+torch\.optim\s+import.*LBFGS", src,
                             re.M), path


# ---------------------------------------------------------------------------
# Not a test: the CPU readings behind this file's draws, `chip_smoke.py`'s
# [1024, 1920] bar and PERF.md's entry on the detector's L-BFGS.
#
#   JAX_PLATFORMS=cpu python -m tests.test_torch_lbfgs [--parent DIR]
#
# It prints, each against scipy's float64 optimum: (1) the first 30 float64
# iterates, the port's and optax's with the input nudged by one ulp, against
# optax's; (2) JAX's fit_logreg at 1000 and 3000 steps on seeds 0-3 of
# both shapes; (3) the port's L-BFGS on `binary_cross_entropy_with_logits`
# and on `logreg_objective` at 96 x 256, 160 x 512, 364 x 1920, and each
# f32 gradient's error at the optimum (the JAX package's form too); (4)
# `chip_smoke.py`'s [1024, 1920] draw: JAX's and the port's fits, and the
# port's L-BFGS fed the exact value and gradient rounded to f32; with
# `--parent`, (5) the fit_logreg of the checkout at DIR on (2)'s seed-2
# draws and on (4)'s.
# ---------------------------------------------------------------------------


def lbfgs_main() -> int:
    import argparse
    import importlib
    import sys

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    args = ap.parse_args()
    torch.set_num_threads(4)

    def rel(p, x, y, best):
        return (objective64(np.ravel(p["weight"]).astype(np.float64), float(np.ravel(p["bias"])[0]),
                            x, y)[0] - best) / best

    def port_fit(x, y, **kw):
        return {k: v.numpy() for k, v in ttl.fit_logreg(x, y, c=C, device="cpu", **kw).items()}

    print("(1) float64 iterates, 30 steps: max relative distance to optax's")
    for n, d in SHAPES:
        x, y = offset_features(n, d, seed=0)
        with jax.enable_x64(True):
            fj, ft, x0 = _logistic_pair(x, y)
            want = optax_iterates(fj, x0, 30)
            nudged = optax_iterates(_logistic_pair(np.nextafter(x.astype(np.float64), np.inf),
                                                   y)[0], x0, 30)
        got = port_iterates(ft, x0, 30)
        dist = [max(np.linalg.norm(a - b) / np.linalg.norm(b) for a, b in zip(g, want))
                for g in (got, nudged)]
        print(f"  {n} x {d}: port {dist[0]:.2e}, optax with the input one ulp off {dist[1]:.2e}")

    print("(2) JAX's fit_logreg over the float64 optimum")
    draws = {}
    for seed in range(4):
        for n, d in SHAPES:
            x, y = offset_features(n, d, seed=seed)
            best = optimum64(x, y)[0]
            draws[seed, n, d] = (x, y, best)
            r = [rel(jtl.fit_logreg(x, y, c=C, max_iter=k), x, y, best) for k in (1000, 3000)]
            print(f"  seed {seed} {n} x {d}: 1000 steps {r[0]:.2e}, 3000 steps {r[1]:.2e}")

    print("(3) the port's L-BFGS by loss form, 1000 steps, seed 0")
    for n, d in SHAPES + [(364, 1920)]:
        x, y = offset_features(n, d, seed=0)
        best, w_best, b_best = optimum64(x, y)
        for name, fn in (("binary_cross_entropy_with_logits",
                          lambda p, x, y, c: torch.nn.functional.binary_cross_entropy_with_logits(
                              x @ p["weight"] + p["bias"], y, reduction="sum")
                          + 0.5 / c * (p["weight"] ** 2).sum()),
                         ("logreg_objective", ttl.logreg_objective)):
            keep, logs = ttl.logreg_objective, []
            ttl.logreg_objective = fn
            try:
                p = port_fit(x, y, log_fn=logs.append)
            finally:
                ttl.logreg_objective = keep
            print(f"  {n} x {d} {name}: {rel(p, x, y, best):.2e} above, "
                  f"{logs[0]['lbfgs']['evaluations'] / logs[0]['lbfgs']['steps']:.2f} "
                  f"evaluations a step")
        if n == 96:  # at the optimum rounded to f32, where each form is evaluated
            w32, b32 = w_best.astype(np.float32), np.float32(b_best)
            z = x.astype(np.float64) @ w32 + float(b32)
            r = 0.5 * (1.0 + np.tanh(0.5 * z)) - y
            exact = np.concatenate([x.astype(np.float64).T @ r + w32 / C, [r.sum()]])
            errs = {}
            xt = torch.from_numpy(x)
            yt = torch.from_numpy(y.astype(np.float32))[:, None]
            pt = {"weight": torch.tensor(w32[:, None], requires_grad=True),
                  "bias": torch.tensor([b32], requires_grad=True)}
            for name, loss in (("binary_cross_entropy_with_logits",
                                lambda z: torch.nn.functional.binary_cross_entropy_with_logits(
                                    z, yt, reduction="sum")),
                               ("logreg_objective", None)):
                for v in pt.values():
                    v.grad = None
                val = (ttl.logreg_objective(pt, xt, yt, C) if loss is None else
                       loss(xt @ pt["weight"] + pt["bias"]) + 0.5 / C * (pt["weight"] ** 2).sum())
                val.backward()
                g = np.concatenate([pt["weight"].grad.numpy()[:, 0], pt["bias"].grad.numpy()])
                errs[name] = np.linalg.norm(g - exact) / np.linalg.norm(exact)
            xj = jnp.asarray(x)
            yj = jnp.asarray(y, jnp.float32)[:, None]

            def jax_objective(p):  # the JAX package's fit_logreg objective
                z = xj @ p["weight"] + p["bias"]
                nll = jnp.sum(jnp.maximum(z, 0.0) - z * yj + jnp.log1p(jnp.exp(-jnp.abs(z))))
                return nll + 0.5 / C * jnp.sum(p["weight"] ** 2)

            gj = jax.jit(jax.grad(jax_objective))(
                {"weight": jnp.asarray(w32[:, None]), "bias": jnp.asarray([b32])})
            g = np.concatenate([np.asarray(gj["weight"])[:, 0], np.asarray(gj["bias"])])
            errs["JAX fit_logreg"] = np.linalg.norm(g - exact) / np.linalg.norm(exact)
            print("  f32 gradient at the optimum, relative error: "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))

    print("(4) chip_smoke.py's [1024, 1920] draw")
    x, y = offset_features(1024, 1920, seed=25)
    best = optimum64(x, y)[0]
    draws["chip"] = (x, y, best)
    for k in (1000, 3000):
        print(f"  {k} steps: JAX {rel(jtl.fit_logreg(x, y, c=C, max_iter=k), x, y, best):.2e}, "
              f"port {rel(port_fit(x, y, max_iter=k), x, y, best):.2e} above")
    xt, yt = torch.from_numpy(x).double(), torch.from_numpy(y.astype(np.float64))[:, None]

    def exact_rounded(v):
        p = {"weight": v[:-1, None].double().requires_grad_(True),
             "bias": v[-1:].double().requires_grad_(True)}
        val = ttl.logreg_objective(p, xt, yt, C)
        g = torch.autograd.grad(val, [p["weight"], p["bias"]])
        return val.float(), torch.cat([g[0][:, 0], g[1]]).float()

    opt = tlb.LBFGS(exact_rounded, torch.zeros(1921))
    for _ in range(2000):
        opt.step()
    w = opt.x.numpy()
    print(f"  2000 steps, exact value and gradient rounded to f32: "
          f"{rel({'weight': w[:-1], 'bias': w[-1:]}, x, y, best):.2e} above")

    if args.parent:
        sys.path.insert(0, args.parent)
        for m in [m for m in sys.modules if m.startswith("xai_audio_deepfakes_tpu_torch")]:
            del sys.modules[m]
        parent = importlib.import_module("xai_audio_deepfakes_tpu_torch.train.train_logreg")
        print(f"(5) {parent.__file__}'s fit_logreg")
        for key in [(2, n, d) for n, d in SHAPES] + ["chip"]:
            x, y, best = draws[key]
            n, d = x.shape
            p = {k: v.numpy() for k, v in parent.fit_logreg(x, y, c=C, device="cpu").items()}
            wj = np.asarray(jtl.fit_logreg(x, y, c=C)["weight"])[:, 0]
            print(f"  {n} x {d}: objective {rel(p, x, y, best) + 1:.3f}x the optimum's, cosine "
                  f"{_cos(p['weight'], wj):.4f} to JAX's fit, |w| {np.linalg.norm(p['weight']):.1f} "
                  f"against JAX's {np.linalg.norm(wj):.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(lbfgs_main())
