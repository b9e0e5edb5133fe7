"""PyTorch port, eval and attribution: the LMAC faithfulness metrics and
their fold, EER and ROC, the five gradient attribution methods and the two
harnesses, against the JAX package on the CPU (tiny f32 pipeline of
tests/test_pipeline.py)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_audio_deepfakes_tpu.attrib import methods as jm
from xai_audio_deepfakes_tpu.metrics import eer as j_eer
from xai_audio_deepfakes_tpu.metrics import lmac_metrics as jl
from xai_audio_deepfakes_tpu.models.logreg import LogReg
from xai_audio_deepfakes_tpu.pipeline.core import ADDvisorPipeline as JPipeline
from tests.test_pipeline import tiny_config
from tests.test_torch_models import random_params
from tests.test_torch_train import tiny
from xai_audio_deepfakes_tpu_torch import config as tc
from xai_audio_deepfakes_tpu_torch.attrib import methods as tm
from xai_audio_deepfakes_tpu_torch.convert import load_jax_params
from xai_audio_deepfakes_tpu_torch.metrics import eer as t_eer
from xai_audio_deepfakes_tpu_torch.metrics import lmac_metrics as tl
from xai_audio_deepfakes_tpu_torch.metrics.harness import (
    run_attribution_metrics,
    run_explanation_metrics,
)
from xai_audio_deepfakes_tpu_torch.models.logreg import logreg_apply
from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline

j_harness = importlib.import_module("xai_audio_deepfakes_tpu.metrics.harness")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Backward passes on several xdist workers: one intra-op thread each
    (see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# metrics/lmac_metrics.py
# ---------------------------------------------------------------------------


def _probs(seed: int, n: int = 40) -> list[np.ndarray]:
    """Three seeded probability columns [n, 1], with 0.5, 0, 1 and values
    straddling 0.5 among them."""
    rng = np.random.default_rng(seed)
    cols = [rng.uniform(size=(n, 1)).astype(np.float32) for _ in range(3)]
    for col, edge in zip(cols, ([0.5, 0.0, 1.0], [0.5000001, 1.0, 0.0], [0.4999999, 0.5, 1.0])):
        col[:3, 0] = edge
    return cols


def test_metric_formulas_match_jax():
    """The five per-clip metrics and the predicted-class score against
    JAX's on seeded probabilities (rtol and atol 1e-6; eps 1e-10)."""
    p, rel, irr = _probs(0)
    t = [torch.from_numpy(a) for a in (p, rel, irr)]
    assert tl.EPS == jl.EPS == 1e-10 and tl.METRIC_KEYS == jl.METRIC_KEYS
    pairs = (
        (tl.compute_faithfulness(t[0], t[2]), jl.compute_faithfulness(p, irr)),
        (tl.compute_fidelity(t[1], t[0]), jl.compute_fidelity(rel, p)),
        (tl.compute_AD(t[1], t[0]), jl.compute_AD(rel, p)),
        (tl.compute_AI(t[1], t[0]), jl.compute_AI(rel, p)),
        (tl.compute_AG(t[1], t[0]), jl.compute_AG(rel, p)),
        (tl.get_score_for_predicted_class(t[0]), jl.get_score_for_predicted_class(p)),
        (tl.compute_fidelity(t[1][:, 0], t[0][:, 0]), jl.compute_fidelity(rel[:, 0], p[:, 0])),
    )
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6,
                                   err_msg=str(i))


def test_summaries_and_fold_match_jax():
    """`summarize`, `summarize_sums` per batch and `merge_summaries` over
    three uneven batches against JAX's (rtol and atol 1e-6), and the same
    clear error on no partials."""
    p, rel, irr = _probs(1, 50)
    want = jl.summarize(p, rel, irr)
    got = tl.summarize(*(torch.from_numpy(a) for a in (p, rel, irr)))
    for k in tl.METRIC_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, atol=1e-6, err_msg=k)
    mine, ref = [], []
    for lo, hi in ((0, 20), (20, 23), (23, 50)):
        cols = [a[lo:hi] for a in (p, rel, irr)]
        sums, count = tl.summarize_sums(*(torch.from_numpy(c) for c in cols))
        j_sums, j_count = jl.summarize_sums(*cols)
        np.testing.assert_allclose(sums.numpy(), np.asarray(j_sums), rtol=1e-6, atol=1e-6)
        assert count == int(j_count) == hi - lo
        mine.append((sums, count))
        ref.append((np.asarray(j_sums), int(j_count)))
    got, want = tl.merge_summaries(mine), jl.merge_summaries(ref)
    assert got.keys() == want.keys() and got["num_clips"] == want["num_clips"] == 50
    for k in tl.METRIC_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    for merge in (tl.merge_summaries, jl.merge_summaries):
        with pytest.raises(ValueError, match="no batches to summarize"):
            merge([])


@pytest.mark.parametrize("case", ["random", "ties", "all_tied", "separable", "inverted",
                                  "one_class", "extremes"])
def test_eer_and_roc_equal_jax(case):
    """`roc_curve` and `compute_eer` equal JAX's exactly, ties and extreme
    scores included."""
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 2, 60)
    scores = {
        "random": rng.standard_normal(60),
        "ties": np.round(rng.standard_normal(60), 1),
        "all_tied": np.full(60, 0.3),
        "separable": labels + 0.1 * rng.uniform(size=60),
        "inverted": -labels + 0.1 * rng.uniform(size=60),
        "one_class": rng.standard_normal(60),
        "extremes": np.where(labels == 1, 1e30, -1e30) * rng.integers(0, 2, 60),
    }[case]
    if case == "one_class":
        labels = np.ones(60, np.int64)
    for got, want in zip(t_eer.roc_curve(scores, labels), j_eer.roc_curve(scores, labels)):
        np.testing.assert_array_equal(got, want)
    assert t_eer.compute_eer(scores, labels) == j_eer.compute_eer(scores, labels)


# ---------------------------------------------------------------------------
# attrib/methods.py and the harnesses, on the tiny f32 pipeline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_pipes():
    """The JAX tiny pipeline and the port's over the same random weights,
    each with its score function (detector logits of a waveform)."""
    cfg = tiny_config()
    jpipe = JPipeline(cfg)
    wav0 = jnp.zeros((1, cfg.audio.num_samples), jnp.float32)
    mag0 = jnp.zeros((1, cfg.unet.freq_bins, cfg.unet.frames), jnp.float32)
    params = {
        "encoder": random_params(jpipe.encoder.init, jax.random.PRNGKey(0), wav0, seed=1),
        "unet": random_params(jpipe.unet.init, jax.random.PRNGKey(0), mag0, seed=2),
        "logreg": jax.tree.map(np.asarray, LogReg.init(cfg.embedder.hidden_size, seed=3)),
    }
    pipe = ADDvisorPipeline(tiny(), device="cpu", seed=4)
    load_jax_params(pipe, params)

    def j_score(w):
        return jpipe.classify(params, w)[0]

    def t_score(w):
        return logreg_apply(pipe.logreg, pipe.embed(w).mean(dim=1))[0]

    wav = np.random.default_rng(6).standard_normal((2, 8000)).astype(np.float32) * 0.1
    return jpipe, params, j_score, pipe, t_score, wav


def _assert_maps_close(got: torch.Tensor, want, what: str) -> None:
    """Attribution maps within 1e-4 of the reference's largest magnitude,
    their `attribution_mask`s within 1e-4."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), err_msg=what)
    np.testing.assert_allclose(tm.attribution_mask(got).numpy(),
                               np.asarray(jm.attribution_mask(jnp.asarray(want))), atol=1e-4,
                               err_msg=f"{what} mask")


@pytest.mark.parametrize("method", ["saliency", "input_x_gradient", "integrated_gradients"])
def test_deterministic_attributions_match_jax(tiny_pipes, method):
    """Saliency, input x gradient and integrated gradients (4 midpoint
    steps) through the port's grad-carrying embed against JAX's methods
    over `pipe.classify`."""
    jpipe, params, j_score, pipe, t_score, wav = tiny_pipes
    kw = {"steps": 4} if method == "integrated_gradients" else {}
    want = jax.jit(lambda w: jm.METHODS[method](j_score, w, **kw))(jnp.asarray(wav))
    got = tm.METHODS[method](t_score, torch.from_numpy(wav), **kw)
    assert float(got.abs().max()) > 0
    _assert_maps_close(got, want, method)


def test_random_attributions_with_jax_draws_match_jax(tiny_pipes):
    """SmoothGrad and GradientShap (3 samples, seeded non-zero baselines) fed
    JAX's own draws for PRNGKey(0): the port's results equal JAX's at the
    same bar. The batch-wide span max(wav) - min(wav) scales the noise."""
    jpipe, params, j_score, pipe, t_score, wav = tiny_pipes
    key, samples, sigma = jax.random.PRNGKey(0), 3, 0.1
    baselines = np.random.default_rng(7).standard_normal((2, 8000)).astype(np.float32) * 0.05
    wj = jnp.asarray(wav)
    keys = jax.random.split(key, samples)
    normals = np.stack([np.asarray(jax.random.normal(k, wav.shape)) for k in keys])
    want = jax.jit(lambda w: jm.smoothgrad(j_score, w, key, samples=samples, sigma=sigma))(wj)
    got = tm._smoothgrad(t_score, torch.from_numpy(wav), torch.from_numpy(normals), sigma)
    _assert_maps_close(got, want, "smoothgrad")

    index, u, normals = [], [], []
    for k in keys:
        kb, ku, kn = jax.random.split(k, 3)
        index.append(np.asarray(jax.random.randint(kb, (2,), 0, 2)))
        u.append(np.asarray(jax.random.uniform(ku, (2, 1))))
        normals.append(np.asarray(jax.random.normal(kn, wav.shape)))
    want = jax.jit(lambda w: jm.gradient_shap(j_score, w, key, baselines=jnp.asarray(baselines),
                                              samples=samples, sigma=sigma))(wj)
    got = tm._gradient_shap(t_score, torch.from_numpy(wav), torch.from_numpy(baselines),
                            *(torch.from_numpy(np.stack(a)) for a in (index, u, normals)), sigma)
    _assert_maps_close(got, want, "gradient_shap")

    g = torch.Generator().manual_seed(1)
    for fn in (tm.smoothgrad, tm.gradient_shap):
        attr = fn(t_score, torch.from_numpy(wav), g, samples=2)
        assert attr.shape == wav.shape and bool(torch.isfinite(attr).all())


def _near_half(*probs) -> str:
    close = [float(v) for p in probs for v in np.ravel(p) if abs(float(v) - 0.5) < 1e-4]
    return f"probabilities within 1e-4 of 0.5: {close}" if close else ""


def test_harnesses_match_jax(tiny_pipes):
    """Both harnesses end to end over two batches of two clips, against
    JAX's on the same weights: the continuous metrics within 1e-4, fidelity,
    AI and the manipulated count exactly (a probability within 1e-4 of 0.5
    would make a decision fragile: the message names any)."""
    jpipe, params, j_score, pipe, t_score, wav = tiny_pipes
    rng = np.random.default_rng(8)
    batches = [rng.standard_normal((2, 8000)).astype(np.float32) * 0.1 for _ in range(2)]
    want = j_harness.run_explanation_metrics(jpipe, params, batches)
    logged = []
    got = run_explanation_metrics(pipe, batches, log_fn=logged.append)
    assert logged == [{"explanation_metrics": got}] and got.keys() == want.keys()
    probs = [pipe.explain(b) for b in batches]
    note = _near_half(*[torch.cat([o.probs_clean, o.probs_relevant, o.probs_irrelevant])
                        for o in probs])
    assert got["num_clips"] == want["num_clips"] == 4
    for k in ("fidelity", "average_increase"):
        assert got[k] == want[k], (k, note)
    for k in ("faithfulness", "average_drop", "average_gain"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=f"{k} {note}")

    want = j_harness.run_attribution_metrics(jpipe, params, batches, method="input_x_gradient")
    seen = []
    got = run_attribution_metrics(pipe, batches, method="input_x_gradient",
                                  artifact_fn=lambda *a: seen.append(a))
    assert len(seen) == 2 and [a.shape for a in seen[0]] == [(2, 8000)] * 4 + [(2, 1)] * 3
    assert all(isinstance(a, np.ndarray) for a in seen[0])
    note = _near_half(*[a for s in seen for a in s[4:]])
    assert got["method"] == want["method"] and got["num_clips"] == want["num_clips"] == 4
    assert got["fidelity"] == want["fidelity"], note
    assert got["relevant_classified_manipulated"] == want["relevant_classified_manipulated"], note
    np.testing.assert_allclose(got["faithfulness"], want["faithfulness"], atol=1e-4, err_msg=note)


def test_harness_refusals(tiny_pipes):
    """The sharded sweep runs: in a gloo world of this process alone it
    equals the plain sweep bit for bit, and there a mesh of two model ranks
    is refused (its product is not the world size). On 8 ranks against
    JAX: tests/test_torch_parallel.py. (Attribution through the int8
    embedder runs: `test_int8_attributions_match_jax`.)"""
    from tests.torch_parallel_cases import world_of_one
    from xai_audio_deepfakes_tpu_torch.config import MeshConfig
    from xai_audio_deepfakes_tpu_torch.parallel.mesh import make_mesh

    pipe, wav = tiny_pipes[3], tiny_pipes[5]
    with world_of_one():
        mesh = make_mesh(MeshConfig(), "cpu")
        assert run_explanation_metrics(pipe, [wav], mesh=mesh) == run_explanation_metrics(
            pipe, [wav])
        with pytest.raises(ValueError, match="world has 1"):
            make_mesh(MeshConfig(model_parallel=2), "cpu")


# ---------------------------------------------------------------------------
# attribution through the int8 embedder
# ---------------------------------------------------------------------------


def _int8_pipes(tiny_pipes, quant: str, fused_attention: bool):
    """tiny_pipes' weights under `quant` on both sides; int8-static with
    JAX's scales, calibrated on 4 seeded clips and loaded through the bridge
    (the `ctx` site's width follows the attention path: on the CPU the JAX
    package runs its unfused attention)."""
    jpipe0, params = tiny_pipes[0], tiny_pipes[1]
    jpipe = JPipeline(jpipe0.cfg.replace(embedder=tc.dataclasses.replace(
        jpipe0.cfg.embedder, quant=quant)))
    if quant == "int8-static":
        calib = np.random.default_rng(9).standard_normal((4, 8000)).astype(np.float32) * 0.1
        params = jpipe.calibrate_quant(params, jnp.asarray(calib), batch_size=2)
        params["quant_scales"] = jax.tree.map(np.asarray, params["quant_scales"])
    cfg = tiny()
    pipe = ADDvisorPipeline(cfg.replace(embedder=tc.dataclasses.replace(
        cfg.embedder, quant=quant, fused_attention=fused_attention)), device="cpu", seed=4)
    load_jax_params(pipe, params)
    if quant == "int8-static":
        assert pipe.quant_scales["ctx"].shape == (2, 32)

    def j_score(w):
        return jpipe.classify(params, w)[0]

    def t_score(w):
        return logreg_apply(pipe.logreg, pipe.embed(w).mean(dim=1))[0]

    return jpipe, params, j_score, pipe, t_score


@pytest.mark.parametrize("method", ["saliency", "input_x_gradient"])
@pytest.mark.parametrize("quant", ["int8", "int8-static"])
def test_int8_attributions_match_jax(tiny_pipes, quant, method):
    """Saliency and input x gradient through the int8 embedder (dynamic
    per-token scales, and static scales calibrated by JAX) against JAX's
    methods at `_assert_maps_close`'s bar, and the attribution harness's
    mask equal to JAX's `attribution_mask` of JAX's map. The gradient flows
    as in JAX: none through the int8 products or `round`, the rest through
    the residual stream, the float layers and, with dynamic scales, the
    scales' `amax`. On the CPU the JAX package's encoder runs its einsum
    attention whatever `fused_attention` says, so the port runs its
    counterpart in the same order (`fused_attention=False`);
    `test_int8_attribution_in_kernel_a_order` covers kernel A's order."""
    jpipe, params, j_score, pipe, t_score = _int8_pipes(tiny_pipes, quant, False)
    wav = tiny_pipes[5]
    want = jax.jit(lambda w: jm.METHODS[method](j_score, w))(jnp.asarray(wav))
    got = tm.METHODS[method](t_score, torch.from_numpy(wav))
    assert float(got.abs().max()) > 0
    _assert_maps_close(got, want, f"{quant} {method}")
    seen = []
    result = run_attribution_metrics(pipe, [wav], method=method,
                                     artifact_fn=lambda *a: seen.append(a))
    assert result["num_clips"] == 2 and np.isfinite(result["faithfulness"])
    np.testing.assert_allclose(seen[0][1], np.asarray(jm.attribution_mask(want)), atol=1e-4)


def test_int8_attribution_in_kernel_a_order(tiny_pipes, monkeypatch):
    """Saliency through the int8 embedder in kernel A's order of operations
    (`fused_attention=True`, its plain version on the CPU) against eager
    JAX, both sides quantizing to JAX's int8 values: within 1e-4 of the
    largest magnitude. Left to its own roundings the port lands 1.1e-4 from
    JAX here (ROADMAP.md Queue 3): one of the 25536 elements quantized at
    layer 0's `ffn_in` site lies within f32 rounding of a rounding boundary
    and takes the other int8 value, and the dynamic scale's gradient, which
    sums acc * sw * g over that token, moves with it."""
    import xai_audio_deepfakes_tpu.ops.quant as jq
    import xai_audio_deepfakes_tpu_torch.models.wav2vec2 as tw

    jpipe, params, j_score, pipe, t_score = _int8_pipes(tiny_pipes, "int8", True)
    wav = tiny_pipes[5]
    recorded, j_quantize = [], jq.quantize_symmetric

    def record(x, axis):
        q, s = j_quantize(x, axis)
        if x.ndim == 3:  # an activation site (weights are 2-D)
            recorded.append(np.array(q))
        return q, s

    monkeypatch.setattr(jq, "quantize_symmetric", record)
    with jax.disable_jit():
        jpipe.features(params, jnp.asarray(wav))
    monkeypatch.setattr(jq, "quantize_symmetric", j_quantize)
    with jax.disable_jit():
        want = jm.saliency(j_score, jnp.asarray(wav))
    assert len(recorded) == 4 * len(pipe.encoder.layers)
    e = pipe.cfg.embedder
    nh, hd = e.num_heads, e.hidden_size // e.num_heads
    sites, t_quantize = iter(recorded), tw.quantize_symmetric

    def inject(x, dim):
        q, s = t_quantize(x, dim)
        jqv = torch.from_numpy(next(sites))
        if jqv.shape != q.shape:  # the head-padded context
            padded = torch.zeros_like(q).reshape(*q.shape[:2], nh, -1)
            padded[..., :hd] = jqv.reshape(*q.shape[:2], nh, hd)
            jqv = padded.reshape(q.shape)
        return jqv, s

    monkeypatch.setattr(tw, "quantize_symmetric", inject)
    got = tm.saliency(t_score, torch.from_numpy(wav))
    assert next(sites, None) is None
    _assert_maps_close(got, want, "int8 saliency, kernel A order, JAX's int8 values")


def test_attribution_sweep_takes_deterministic_cudnn(tiny_pipes, monkeypatch):
    """The sweep's gradients run with cuDNN's deterministic algorithms (on
    the card two sweeps then give the same maps, which chip_smoke.py
    checks), and the caller's setting is back after it. A `generator` for
    the random methods travels in the method's keywords: the same seed
    gives the same map, another seed another."""
    pipe, wav = tiny_pipes[3], tiny_pipes[5]
    seen, embed = [], pipe.embed

    def spy(w, *args, **kw):
        seen.append((w.requires_grad, torch.backends.cudnn.deterministic))
        return embed(w, *args, **kw)

    monkeypatch.setattr(pipe, "embed", spy)
    before = torch.backends.cudnn.deterministic
    maps = []
    for seed in (1, 1, 2):
        run_attribution_metrics(pipe, [wav], method="smoothgrad", samples=2,
                                generator=torch.Generator().manual_seed(seed),
                                artifact_fn=lambda *a: maps.append(a[1]))
    assert torch.backends.cudnn.deterministic == before
    assert {d for grad, d in seen if grad} == {True}, seen
    np.testing.assert_array_equal(maps[0], maps[1])
    assert not np.array_equal(maps[0], maps[2])
