"""PyTorch port, the detector head: its L-BFGS fit, evaluation and split,
the head's save / load / joblib import, and mask-localisation scoring,
against the JAX package and scikit-learn on the CPU.

Bars: the split, the head's files and its import bit for bit; the fit's
weights at cosine above 0.999 against scikit-learn and against JAX's
`fit_logreg` (as `tests/test_harness_cli.py::test_train_detector_separable`
holds JAX's), accuracy equal and EER within 1e-6 of JAX's `train_detector`;
localisation statistics within 1e-6.
"""

import numpy as np
import pytest
import torch

from xai_audio_deepfakes_tpu.config import STFTConfig as JSTFTConfig
from xai_audio_deepfakes_tpu.metrics import localization as jloc
from xai_audio_deepfakes_tpu.models import logreg as jlr
from xai_audio_deepfakes_tpu.train import train_logreg as jtl
from tests.test_torch_train import tiny
from xai_audio_deepfakes_tpu_torch.config import STFTConfig
from xai_audio_deepfakes_tpu_torch.metrics import localization as tloc
from xai_audio_deepfakes_tpu_torch.models import logreg as tlr
from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline
from xai_audio_deepfakes_tpu_torch.train import train_logreg as ttl

CFG, JCFG = STFTConfig(), JSTFTConfig()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Gradients on several xdist workers: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cos(a, b) -> float:
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _features(kind: str, n: int = 400, d: int = 8, seed: int = 0):
    """Seeded features with a linear label: `separable` exactly, `noisy`
    with logistic label noise (a finite optimum), `weak` with the same noise
    over a signal of unit scale (a flat objective, labels near coin flips),
    `offset` the noisy features shifted by a common vector, as pooled
    embeddings are."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    z = x @ (w / np.linalg.norm(w) if kind == "weak" else w)
    if kind != "separable":
        z = z + rng.logistic(size=n)
    if kind == "offset":
        x = x + rng.uniform(1.0, 3.0, d).astype(np.float32)
    return x, (z > 0).astype(np.int64)


# ---------------------------------------------------------------------------
# train/train_logreg.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("test_size,seed", [(0.2, 42), (0.25, 0), (0.5, 7)])
def test_stratified_split_equals_jax(test_size, seed):
    x, y = _features("noisy", n=101, seed=1)
    y[:3] = 2  # a third, rare class keeps one test clip
    for mine, ref in zip(ttl.stratified_split(x, y, test_size, seed),
                         jtl.stratified_split(x, y, test_size, seed)):
        np.testing.assert_array_equal(mine, ref)


def test_objective_gradient_at_zero_is_sigmoids():
    """At w = 0, b = 0 (the fit's start, every logit exactly 0) the
    objective's gradient is X^T (sigmoid(0) - y), as JAX's is."""
    x, y = _features("offset", n=50, seed=3)
    params = {"weight": torch.zeros((8, 1), requires_grad=True),
              "bias": torch.zeros((1,), requires_grad=True)}
    yt = torch.from_numpy(y.astype(np.float32))[:, None]
    ttl.logreg_objective(params, torch.from_numpy(x), yt, 1e6).backward()
    r = 0.5 - y.astype(np.float64)
    np.testing.assert_allclose(params["weight"].grad.numpy()[:, 0], x.T @ r, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(params["bias"].grad.numpy(), [r.sum()], rtol=1e-6)


@pytest.mark.parametrize("kind,seed", [("separable", 0), ("noisy", 0), ("weak", 1),
                                       ("offset", 0)])
def test_fit_logreg_matches_sklearn_and_jax(kind, seed):
    """The fit's weights at cosine above 0.999 against scikit-learn's
    LogisticRegression(C=1e6) and JAX's fit_logreg; with noisy labels its
    objective within 1e-4 (relative) of scikit-learn's optimum (where the
    line search gets no evaluation, the weak case stalls 15% above it; with
    a wrong first gradient the offset case never leaves w = 0)."""
    from sklearn.linear_model import LogisticRegression

    x, y = _features(kind, seed=seed)
    logs = []
    params = ttl.fit_logreg(x, y, c=1e6, device="cpu", log_fn=logs.append)
    assert set(params) == {"weight", "bias"} and params["weight"].shape == (8, 1)
    assert not params["weight"].requires_grad
    (stats,) = [r["lbfgs"] for r in logs]
    assert 1 <= stats["steps"] <= 1000 and stats["evaluations"] >= stats["steps"]
    clf = LogisticRegression(C=1e6, max_iter=10000).fit(x, y)
    w = params["weight"].numpy()[:, 0]
    assert _cos(w, clf.coef_[0]) > 0.999
    assert _cos(w, np.asarray(jtl.fit_logreg(x, y, c=1e6)["weight"])) > 0.999
    if kind != "separable":
        xt, yt = torch.from_numpy(x), torch.from_numpy(y.astype(np.float32))[:, None]
        sk = {"weight": torch.from_numpy(clf.coef_.T.astype(np.float32)),
              "bias": torch.from_numpy(clf.intercept_.astype(np.float32))}
        mine = float(ttl.logreg_objective(params, xt, yt, 1e6))
        best = float(ttl.logreg_objective(sk, xt, yt, 1e6))
        assert abs(mine - best) <= 1e-4 * best, (mine, best)


@pytest.mark.parametrize("kind", ["separable", "noisy"])
def test_train_detector_matches_jax(kind):
    """Split, fit and evaluate: accuracy equal to JAX's, EER within 1e-6,
    and the metrics logged after the fit's statistics."""
    x, y = _features(kind, n=300, d=6, seed=2)
    logs = []
    params, metrics = ttl.train_detector(x, y, device="cpu", log_fn=logs.append)
    _, want = jtl.train_detector(x, y)
    assert metrics["accuracy"] == want["accuracy"]
    assert abs(metrics["eer"] - want["eer"]) <= 1e-6
    assert [next(iter(r)) for r in logs] == ["lbfgs", "detector"] and logs[1]["detector"] == metrics
    x_tr, x_te, y_tr, y_te = ttl.stratified_split(x, y)
    assert ttl.evaluate_logreg(params, x_te, y_te) == metrics


def test_fit_logreg_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    x, y = _features("noisy", n=20)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttl.fit_logreg(x, y)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlr.logreg_params_from_arrays(np.zeros(3), np.zeros(1))


# ---------------------------------------------------------------------------
# models/logreg.py: the head's files
# ---------------------------------------------------------------------------


def test_head_files_round_trip_and_cross_load(tmp_path):
    """logreg_params_save -> logreg_params_from_any bit for bit; the port
    reads the JAX package's .npz and the JAX package reads the port's."""
    rng = np.random.default_rng(3)
    coef, intercept = rng.standard_normal((1, 32)), rng.standard_normal(1)
    params = tlr.logreg_params_from_arrays(coef, intercept, device="cpu")
    want = jlr.logreg_params_from_arrays(coef, intercept)
    for k in ("weight", "bias"):
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(want[k]))
    tlr.logreg_params_save(params, str(tmp_path / "t.npz"))
    jlr.logreg_params_save(want, str(tmp_path / "j.npz"))
    for path in ("t.npz", "j.npz"):
        back = tlr.logreg_params_from_any(str(tmp_path / path), device="cpu")
        jback = jlr.logreg_params_from_any(str(tmp_path / path))
        for k in ("weight", "bias"):
            assert back[k].dtype == torch.float32 and back[k].shape == params[k].shape
            np.testing.assert_array_equal(back[k].numpy(), params[k].numpy())
            np.testing.assert_array_equal(np.asarray(jback[k]), params[k].numpy())


def test_joblib_head_drops_into_the_pipeline(tmp_path):
    """A scikit-learn joblib checkpoint loads as JAX loads it, and the head
    serves in `ADDvisorPipeline.logreg`: `classify` equals the head applied
    to the pooled features."""
    import joblib
    from sklearn.linear_model import LogisticRegression

    cfg = tiny()
    x, y = _features("noisy", n=60, d=cfg.embedder.hidden_size, seed=4)
    path = str(tmp_path / "logReg_vocoded_anyband.joblib")
    joblib.dump(LogisticRegression(C=1.0, max_iter=500).fit(x, y), path)
    head = tlr.logreg_params_from_any(path, device="cpu")
    want = jlr.logreg_params_from_joblib(path)
    for k in ("weight", "bias"):
        np.testing.assert_array_equal(head[k].numpy(), np.asarray(want[k]))
    pipe = ADDvisorPipeline(cfg, device="cpu", seed=0)
    pipe.logreg = head
    wav = np.random.default_rng(5).standard_normal((2, 8000)).astype(np.float32) * 0.1
    logits, probs = pipe.classify(wav)
    ref_logits, ref_probs = tlr.logreg_apply(head, pipe.features(wav).mean(dim=1))
    torch.testing.assert_close(logits, ref_logits, rtol=0, atol=0)
    torch.testing.assert_close(probs, ref_probs, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# metrics/localization.py
# ---------------------------------------------------------------------------


def _assert_stats_close(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k == "per_clip":
            assert len(got[k]) == len(v)
            for a, b in zip(got[k], v):
                assert a.keys() == b.keys()
                np.testing.assert_allclose([a[n] for n in a], [b[n] for n in b], atol=1e-6)
        elif v is None:
            assert got[k] is None, k
        else:
            np.testing.assert_allclose(got[k], v, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("crop", [(None, None), (512, 248)], ids=["full", "decoder-crop"])
def test_per_clip_band_stats_match_jax(crop):
    """Soft masks over 6 clips, two sharing a band, against JAX's stats."""
    rng = np.random.default_rng(6)
    masks = rng.uniform(0, 1, (6, CFG.num_bins, 249)).astype(np.float32)
    bands = np.array([[0, 1e3], [3e3, 4e3], [3e3, 4e3], [7e3, 8e3], [5e3, 6e3], [1e3, 2e3]])
    masks[1, 190:260] += 0.6  # clip 1 marks its own 3-4 kHz band
    fb, fr = crop
    got = tloc.per_clip_band_stats(masks, CFG, bands, freq_bins=fb, frames=fr)
    want = jloc.per_clip_band_stats(masks, JCFG, bands, freq_bins=fb, frames=fr)
    _assert_stats_close(got, want)
    assert got["cross_band_pair_iou"] is not None and got["same_band_pair_iou"] is not None


@pytest.mark.parametrize("lo,hi,crop", [(3e3, 4e3, (None, None)), (0.0, 2e3, (512, 248)),
                                        (7e3, 8e3, (512, 248))])
def test_mask_band_stats_match_jax(lo, hi, crop):
    rng = np.random.default_rng(7)
    mask = rng.uniform(0, 1, (3, CFG.num_bins, 249)).astype(np.float32) ** 3
    got = tloc.mask_band_stats(mask, CFG, lo, hi, freq_bins=crop[0], frames=crop[1])
    want = jloc.mask_band_stats(mask, JCFG, lo, hi, freq_bins=crop[0], frames=crop[1])
    _assert_stats_close(got, want)
