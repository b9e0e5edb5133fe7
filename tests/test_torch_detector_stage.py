"""PyTorch port: the closed loop's detector stage held against the JAX
package's, stage by stage, in the protocol's regime: the detector corpus
separable, and (here) the split's training rows fewer than the embedding's
features.

Both sides start from JAX's own seed-0 draw (`reference_draw.jax_init_params`,
loaded into the port by `convert.load_jax_params`; JAX takes the same tree,
which tests/test_torch_reference_draw.py holds equal to its
`init_params(PRNGKey(0))`). The JAX side is the JAX package's own functions
in `run_closed_loop`'s order (`make_anyband_corpus` twice,
`detector_corpus_anyband`, the loop's padded embed, `train_detector`,
`evaluate_logreg`, then the first epoch's shuffle and `make_train_step`);
the port's are its counterparts. Each stage takes the same inputs on both
sides, JAX's output of the stage before, so differences do not compound:

1. the corpora from one numpy seed: the drawn clips, bands and labels and
   the rng's state after each draw bit-equal; a clip that went through the
   STFT and back (the spliced and band-filtered ones) within `SPLICE_ULPS`
   f32 ulps of the corpus's largest magnitude (two f32 DFT sum orders);
2. the embeddings, the mean-pooled `features` of the detector corpus and
   the evaluation clips, the tail padded as the loop pads it: f32 within
   1e-5 relative; bf16 at the embedder's bf16 bar (mean deviation at most
   0.4x JAX's own bf16-vs-f32 mean, max at most the larger of its max and
   two bf16 steps), JAX compiled with every bf16 rounding kept;
3. the fit on JAX's embeddings (the same `stratified_split`, seed 42): 1 -
   cosine to JAX's weights, and |w|, the median |logit| and the objective
   on the training rows, relative, each at most `SPREAD_MARGIN` times the
   largest that JAX's own fit moves by when every element of its input is
   moved one f32 ulp (`SPREAD_DRAWS` seeded draws). A 1000-step f32 L-BFGS
   of a separable corpus ends where rounding sets it: at tiny width such a
   move turns JAX's fit by 1 - cosine 2e-5 to 1.5e-3 and moves its median
   |logit| by up to 0.7%, so the bars the offset-features fit is held to
   (`tests/test_torch_lbfgs.py`: objective 1e-4, cosine 0.9999, 0.5%),
   which the JAX package misses against itself here, are reported beside
   it (`lbfgs_test_bar`) and not asserted;
4. JAX's head on JAX's embeddings: accuracy and EER equal on the split and
   on the evaluation corpus;
5. JAX's head on JAX's first training batch (the first epoch's shuffle):
   the untrained decoder's total, l_in, l_out and l1 through each side's
   own training step, within 1e-4 relative in f32; in bf16 within half
   JAX's own bf16-vs-f32 deviation or that f32 bar, whichever is larger
   (tests/test_torch_protocol_step.py's bars).

    python -m tests.test_torch_detector_stage --layers 2 --n-train 32 --n-eval 16 [--batch 4]

runs the same stages at the protocol's width (`closed_loop.anyband_protocol_config()`:
hidden 1920, 16 heads, 5 s clips, noise rms 1.0) on the CPU, with the depth,
the clip counts and the batch cut as the flags say, and then the chain end
to end: each side on its own corpus, embeddings, head and first batch, no
state carried over. It prints one JSON line: per precision the stages'
deviations and bars, the port's fit of stage 3 again with the JAX
package's f32 form of the loss (`jax_loss_form`), per side the chain's
|w|, median |logit|, L-BFGS steps,
split and held-out accuracy and EER and the first batch's losses, the
ratio of the two sides' `l_out` beside JAX's own bf16-vs-f32 ratio, the wall
seconds and the peak resident memory.
"""

import argparse
import contextlib
import dataclasses
import json
import resource
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_audio_deepfakes_tpu.config import AudioConfig as JAudio
from xai_audio_deepfakes_tpu.config import EmbedderConfig as JEmbedder
from xai_audio_deepfakes_tpu.config import PipelineConfig as JPipelineConfig
from xai_audio_deepfakes_tpu.config import TrainConfig as JTrain
from xai_audio_deepfakes_tpu.config import UNetConfig as JUNet
from xai_audio_deepfakes_tpu.data import synthetic as js
from xai_audio_deepfakes_tpu.pipeline.core import ADDvisorPipeline as JPipeline
from xai_audio_deepfakes_tpu.train import train_logreg as jtl
from tests.test_torch_lbfgs import _cos, objective64
from tests.test_torch_protocol_step import PROTOCOL_EMBEDDER, f32_bar, j_train, with_dtype
from xai_audio_deepfakes_tpu_torch import config as tc
from xai_audio_deepfakes_tpu_torch.convert import load_jax_params
from xai_audio_deepfakes_tpu_torch.data import synthetic as ts
from xai_audio_deepfakes_tpu_torch.models.logreg import logreg_apply
from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline
from xai_audio_deepfakes_tpu_torch.reference_draw import jax_init_params
from xai_audio_deepfakes_tpu_torch.train import closed_loop as tcl
from xai_audio_deepfakes_tpu_torch.train import train_logreg as ttl
from xai_audio_deepfakes_tpu_torch.train.train_addvisor import init_train_state, make_train_step

BAND_WIDTH, F_MAX, NOISE_RMS = 1000.0, 8000.0, 1.0
SPLICE_ULPS = 16
EMBED_F32_REL = 1e-5
FIT_OBJECTIVE_REL, FIT_COSINE, FIT_NORM_REL = 1e-4, 0.9999, 5e-3
SPREAD_DRAWS, SPREAD_MARGIN = 2, 2.0
LOSS_KEYS = ("loss", "l_in", "l_out", "l1")
DTYPES = ("float32", "bfloat16")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Fits and training steps on several xdist workers: one intra-op
    thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the two sides, stage by stage
# ---------------------------------------------------------------------------


def corpora(side: str, cfg, seed: int, n_train: int, n_eval: int, batch: int) -> dict:
    """`run_closed_loop(anyband=True)`'s draws on one side ("jax" or
    "port"), in its order, and the first epoch's first batch; "rng_states"
    holds the numpy rng's state after each draw."""
    rng = np.random.default_rng(seed)
    n, sc = cfg.audio.num_samples, cfg.stft
    kw = {} if side == "jax" else {"device": "cpu"}
    syn = js if side == "jax" else ts
    out: dict = {"rng_states": []}
    for part, count in (("tr", n_train), ("ev", n_eval)):
        (out[f"real_{part}"], out[f"manip_{part}"],
         out[f"bands_{part}"]) = syn.make_anyband_corpus(rng, count, n, sc, BAND_WIDTH, F_MAX,
                                                         NOISE_RMS, **kw)
        out["rng_states"].append(rng.bit_generator.state)
    out["det"], out["y"] = syn.detector_corpus_anyband(
        out["real_tr"], out["manip_tr"], sc, out["bands_tr"], BAND_WIDTH, F_MAX, rng=rng,
        noise_rms=NOISE_RMS, **kw)
    out["rng_states"].append(rng.bit_generator.state)
    order = np.arange(n_train)
    rng.shuffle(order)
    out["first_batch"] = out["manip_tr"][order[:batch]]
    out["y_ev"] = np.concatenate([np.zeros(n_eval, np.int64), np.ones(n_eval, np.int64)])
    return out


def jax_embed(jcfg, params: dict, batch: int):
    """The loop's embed: mean-pooled `features`, `batch` clips a call, the
    tail padded with its last clip. f32 jitted as the loop jits it; bf16
    compiled with every bf16 rounding kept (under plain jit XLA's CPU fusion
    drops some, tests/test_torch_bf16.py)."""
    jpipe = JPipeline(jcfg)
    fn = jax.jit(lambda p, w: jnp.mean(jpipe.features(p, w), axis=1))
    enc = {"encoder": jax.tree.map(jnp.asarray, params["encoder"])}
    compiled: list = []

    def embed_all(wavs: np.ndarray) -> np.ndarray:
        out = []
        for i in range(0, len(wavs), batch):
            chunk = wavs[i:i + batch]
            k = len(chunk)
            if k < batch:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], batch - k, axis=0)])
            args = (enc, jnp.asarray(chunk))
            if not compiled:
                opts = ({"xla_allow_excess_precision": False}
                        if jcfg.embedder.dtype == "bfloat16" else {})
                compiled.append(fn.lower(*args).compile(compiler_options=opts))
            out.append(np.asarray(compiled[0](*args))[:k])
        return np.concatenate(out)

    return embed_all


def port_embed(tcfg, params: dict, batch: int):
    pipe = ADDvisorPipeline(tcfg, device="cpu", seed=5)
    load_jax_params(pipe, params)
    return lambda wavs: tcl.embed_mean(pipe, wavs, batch)


def embeddings(embed_all, c: dict) -> tuple[np.ndarray, np.ndarray]:
    """(the detector corpus's embeddings, the evaluation clips': real, then
    manipulated, as the loop concatenates them)."""
    return embed_all(c["det"]), np.concatenate([embed_all(c["real_ev"]),
                                                embed_all(c["manip_ev"])])


@contextlib.contextmanager
def counting_jit():
    """Count this thread's calls of the functions `jax.jit` makes inside
    the block: the L-BFGS steps of the JAX package's `fit_logreg` (its loop
    calls one jitted step per iteration)."""
    calls, me, real = [0], threading.get_ident(), jax.jit

    def jit(fn, *a, **k):
        f = real(fn, *a, **k)

        def counted(*args, **kw):
            calls[0] += threading.get_ident() == me
            return f(*args, **kw)

        return counted

    jax.jit = jit
    try:
        yield calls
    finally:
        jax.jit = real


def fit(side: str, x: np.ndarray, y: np.ndarray) -> tuple[dict, dict, int]:
    """That side's `train_detector` -> (head as numpy f32, split metrics,
    L-BFGS steps)."""
    if side == "jax":
        with counting_jit() as calls:
            head, metrics = jtl.train_detector(x, y)
        steps = calls[0]
    else:
        logs: list = []
        head, metrics = ttl.train_detector(x, y, log_fn=logs.append, device="cpu")
        steps = next(r["lbfgs"]["steps"] for r in logs if "lbfgs" in r)
    return {k: np.asarray(v, np.float32) for k, v in head.items()}, metrics, steps


def head_summary(head: dict, x: np.ndarray, y: np.ndarray) -> dict:
    """The head on its split's training rows, in float64: the objective,
    |w| and the median |logit|."""
    x_tr, _, y_tr, _ = ttl.stratified_split(x, y)
    w = head["weight"][:, 0].astype(np.float64)
    obj, z = objective64(w, float(head["bias"][0]), x_tr, y_tr)
    return {"objective": obj, "w_norm": float(np.linalg.norm(w)),
            "median_abs_logit": float(np.median(np.abs(z))), "train_rows": int(len(x_tr)),
            "features": int(x.shape[1])}


def evaluate(side: str, head: dict, x: np.ndarray, y: np.ndarray, x_ev, y_ev) -> dict:
    """Accuracy and EER on the split's held-out rows and on the evaluation
    corpus, by that side's `evaluate_logreg`."""
    _, x_te, _, y_te = ttl.stratified_split(x, y)
    if side == "jax":
        ev = jtl.evaluate_logreg
        h = jax.tree.map(jnp.asarray, head)
    else:
        ev = ttl.evaluate_logreg
        h = {k: torch.from_numpy(v) for k, v in head.items()}
    return {"split": ev(h, x_te, y_te), "held_out": ev(h, x_ev, y_ev)}


class FirstLosses:
    """The untrained decoder's losses on one batch through each side's own
    training step, with a given head: the JAX package's `make_train_step`
    from its `init_train_state` (compiled once a precision for its losses
    alone, every bf16 rounding kept; the head is an argument) and the
    port's `make_train_step` from its `init_train_state`."""

    def __init__(self, jcfg, tcfg, params: dict):
        self.params, self.cfgs, self.jax = params, {}, {}
        for dtype in DTYPES:
            jc_, self.cfgs[dtype] = with_dtype(jcfg, tcfg, dtype)
            jpipe = JPipeline(jc_)
            tx_m, tx_w = j_train.make_optimizers(jc_)
            tree = jax.tree.map(jnp.asarray, {k: params[k] for k in ("encoder", "unet",
                                                                       "logreg")})
            step = j_train.make_train_step(jpipe, tx_m, tx_w)
            self.jax[dtype] = (jax.jit(lambda st, fr, w, step=step: step(st, fr, w)[1]["loss_vec"]),
                               j_train.init_train_state(jpipe, tree, tx_m, tx_w),
                               tree["encoder"], [])

    def port(self, dtype: str, head: dict, wav: np.ndarray) -> np.ndarray:
        pipe = ADDvisorPipeline(self.cfgs[dtype], device="cpu", seed=5)
        load_jax_params(pipe, {**self.params, "logreg": head})
        _, aux = make_train_step(pipe)(init_train_state(pipe), wav)
        return aux["loss_vec"].double().numpy()

    def jax_side(self, dtype: str, head: dict, wav: np.ndarray) -> np.ndarray:
        fn, state, encoder, compiled = self.jax[dtype]
        args = (state, {"encoder": encoder, "logreg": jax.tree.map(jnp.asarray, head)},
                jnp.asarray(wav))
        if not compiled:
            compiled.append(fn.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False}))
        return np.asarray(compiled[0](*args), np.float64)


# ---------------------------------------------------------------------------
# the comparisons
# ---------------------------------------------------------------------------


def splice_dev(jax_c: dict, port_c: dict) -> dict:
    """Stage 1: which parts are bit-equal, and the STFT-processed clips'
    largest distance in ulps of the corpus's largest magnitude."""
    out = {"rng_states_equal": jax_c["rng_states"] == port_c["rng_states"]}
    for key in ("real_tr", "bands_tr", "real_ev", "bands_ev", "y"):
        out[f"{key}_equal"] = bool(np.array_equal(jax_c[key], port_c[key]))
    for key in ("manip_tr", "manip_ev", "det", "first_batch"):
        a, b = jax_c[key], port_c[key]
        out[f"{key}_shape_equal"] = a.shape == b.shape
        if a.shape == b.shape:
            out[key] = {"bit_equal_share": float(np.mean(a == b)),
                        "max_ulps": float(np.abs(a - b).max() / np.spacing(np.abs(a).max()))}
    return out


def stage_1_holds(dev: dict) -> bool:
    return (all(v for k, v in dev.items() if k.endswith("_equal"))
            and all(dev[k]["max_ulps"] <= SPLICE_ULPS
                    for k in ("manip_tr", "manip_ev", "det", "first_batch")))


def embed_dev(mine: np.ndarray, ref: np.ndarray, ref_f32: np.ndarray | None) -> dict:
    """Stage 2: f32 (no `ref_f32`) relative to the largest |JAX|; bf16 at
    the embedder's bf16 bars."""
    err = np.abs(mine.astype(np.float64) - ref)
    if ref_f32 is None:
        rel = float(err.max() / np.abs(ref).max())
        return {"max_rel": rel, "bar": EMBED_F32_REL, "holds": rel <= EMBED_F32_REL}
    own = np.abs(ref.astype(np.float64) - ref_f32)
    two_steps = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7 + 1)
    out = {"mean": float(err.mean()), "mean_bar": float(0.4 * own.mean()),
           "max": float(err.max()), "max_bar": float(max(own.max(), two_steps))}
    out["holds"] = out["mean"] <= out["mean_bar"] and out["max"] <= out["max_bar"]
    return out


def ulp_moved(x: np.ndarray, seed: int) -> np.ndarray:
    """x with every element moved one f32 ulp up or down, at random."""
    up = np.random.default_rng(seed).random(x.shape) < 0.5
    return np.where(up, np.nextafter(x, np.float32(np.inf)),
                    np.nextafter(x, np.float32(-np.inf))).astype(np.float32)


def fit_measures(x: np.ndarray, y: np.ndarray, head_j: dict, head: dict) -> dict:
    """How far `head` is from JAX's fit `head_j` of the same rows: 1 -
    cosine, and |w|, the median |logit| and the float64 objective on the
    training rows, relative."""
    sj, s = head_summary(head_j, x, y), head_summary(head, x, y)
    return {"one_minus_cosine": 1.0 - _cos(head["weight"], head_j["weight"]),
            "w_norm_rel": abs(s["w_norm"] / sj["w_norm"] - 1.0),
            "median_abs_logit_rel": abs(s["median_abs_logit"] / sj["median_abs_logit"] - 1.0),
            "objective_rel": abs(s["objective"] - sj["objective"]) / sj["objective"]}


def fit_dev(x: np.ndarray, y: np.ndarray, head_j: dict, head_t: dict, spread_heads) -> dict:
    """Stage 3: the port's fit of JAX's rows against JAX's, at the bars of
    the offset-features fit (`tests/test_torch_lbfgs.py`) and at JAX's own
    rounding spread (`spread_heads`: JAX's fits of the rows moved by one
    ulp, `SPREAD_DRAWS` draws)."""
    dev = fit_measures(x, y, head_j, head_t)
    fixed = {"one_minus_cosine": 1.0 - FIT_COSINE, "w_norm_rel": FIT_NORM_REL,
             "median_abs_logit_rel": FIT_NORM_REL, "objective_rel": FIT_OBJECTIVE_REL}
    spread = [fit_measures(x, y, head_j, h) for h in spread_heads]
    bar = {k: SPREAD_MARGIN * max(d[k] for d in spread) for k in dev}
    return {"jax": head_summary(head_j, x, y), "port": head_summary(head_t, x, y),
            "port_vs_jax": dev, "lbfgs_test_bar": fixed,
            "lbfgs_test_bar_holds": all(dev[k] <= fixed[k] for k in dev),
            "jax_ulp_spread": spread, "spread_bar": bar,
            "holds": all(dev[k] <= bar[k] for k in dev)}


def loss_dev(port: np.ndarray, want: np.ndarray, want_f32: np.ndarray | None) -> dict:
    """Stage 5: per loss term, |port - JAX| against the f32 bar or, in
    bf16, the larger of it and half JAX's own bf16-vs-f32 deviation."""
    bar = f32_bar(want)
    if want_f32 is not None:
        bar = np.maximum(0.5 * np.abs(want - want_f32), bar)
    err = np.abs(port - want)
    return {"port": dict(zip(LOSS_KEYS, port.tolist())),
            "jax": dict(zip(LOSS_KEYS, want.tolist())),
            "err": dict(zip(LOSS_KEYS, err.tolist())), "bar": dict(zip(LOSS_KEYS, bar.tolist())),
            "holds": bool((err <= bar).all())}


def stages(jcfg, tcfg, n_train: int, n_eval: int, batch: int) -> dict:
    """Stages 1-5 in f32 and bf16 (module docstring), each on JAX's output
    of the stage before. Also keeps, for the chain, the port's corpus and
    each side's per-precision embedder and embeddings."""
    params = jax_init_params(tcfg, 0, device="cpu")
    jax_c = corpora("jax", jcfg, 0, n_train, n_eval, batch)
    port_c = corpora("port", tcfg, 0, n_train, n_eval, batch)
    out: dict = {"stage_1": splice_dev(jax_c, port_c), "rows": int(len(jax_c["y"])),
                 "_jax_c": jax_c, "_port_c": port_c}
    losses = FirstLosses(jcfg, tcfg, params)
    out["_losses"] = losses
    x_j32 = None
    for dtype in DTYPES:
        jc_, tc_ = with_dtype(jcfg, tcfg, dtype)
        j_embed, t_embed = jax_embed(jc_, params, batch), port_embed(tc_, params, batch)
        xj, xj_ev = embeddings(j_embed, jax_c)
        xt, xt_ev = embeddings(t_embed, jax_c)
        if dtype == "float32":
            x_j32 = (xj, xj_ev)
        ref32 = None if dtype == "float32" else np.concatenate(x_j32)
        res: dict = {"stage_2": embed_dev(np.concatenate([xt, xt_ev]),
                                          np.concatenate([xj, xj_ev]), ref32)}
        y = jax_c["y"]
        with ThreadPoolExecutor(SPREAD_DRAWS) as pool:  # overlapped with the two fits
            spread = [pool.submit(jtl.train_detector, ulp_moved(xj, seed), y)
                      for seed in range(SPREAD_DRAWS)]
            head_j, _, steps_j = fit("jax", xj, y)
            head_t, _, steps_t = fit("port", xj, y)
            spread = [{k: np.asarray(v, np.float32) for k, v in f.result()[0].items()}
                      for f in spread]
        res["stage_3"] = {**fit_dev(xj, y, head_j, head_t, spread),
                          "lbfgs_steps": {"jax": steps_j, "port": steps_t}}
        res["_head_j"] = head_j
        ej = evaluate("jax", head_j, xj, y, xj_ev, jax_c["y_ev"])
        et = evaluate("port", head_j, xj, y, xj_ev, jax_c["y_ev"])
        res["stage_4"] = {"jax": ej, "port": et, "holds": ej == et}
        wav = jax_c["first_batch"]
        want = losses.jax_side(dtype, head_j, wav)
        want_f32 = None if dtype == "float32" else losses.jax_side("float32", head_j, wav)
        res["stage_5"] = loss_dev(losses.port(dtype, head_j, wav), want, want_f32)
        if want_f32 is not None:
            res["stage_5"]["jax_f32"] = dict(zip(LOSS_KEYS, want_f32.tolist()))
        res["_embed"] = {"jax": j_embed, "port": t_embed, "jax_x": (xj, xj_ev)}
        out[dtype] = res
    return out


def jax_loss_form(params: dict, x: torch.Tensor, y: torch.Tensor, c: float) -> torch.Tensor:
    """`train_logreg.logreg_objective` in the JAX package's f32 form,
    max(z, 0) - z y + log1p(exp(-|z|)), with its derivative 1/2 at z = 0:
    its gradient cancels at large |z| where the port's form keeps full
    precision (`train/train_logreg.py::logreg_objective`)."""
    z = logreg_apply(params, x)[0]
    relu = torch.where(z > 0, z, torch.zeros_like(z)) + 0.5 * z * (z == 0)
    nll = (relu - z * y + torch.log1p(torch.exp(-z.abs()))).sum()
    return nll + 0.5 / c * (params["weight"] ** 2).sum()


def loss_form_dev(run: dict) -> dict:
    """Per precision, the port's fit of JAX's rows with the JAX package's
    loss form, against JAX's fit (`fit_measures`): what of stage 3's
    difference the two loss forms make."""
    out, own = {}, ttl.logreg_objective
    ttl.logreg_objective = jax_loss_form
    try:
        for dtype in DTYPES:
            x, y = run[dtype]["_embed"]["jax_x"][0], run["_jax_c"]["y"]
            out[dtype] = fit_measures(x, y, run[dtype]["_head_j"], fit("port", x, y)[0])
    finally:
        ttl.logreg_objective = own
    return out


def chain(run: dict) -> dict:
    """Each side on its own: its corpus, embeddings, head, held-out metrics
    and first batch's losses, nothing carried over from the other."""
    out: dict = {}
    for dtype in DTYPES:
        emb = run[dtype]["_embed"]
        out[dtype] = {}
        for side, c in (("jax", run["_jax_c"]), ("port", run["_port_c"])):
            x, x_ev = emb["jax_x"] if side == "jax" else embeddings(emb["port"], c)
            head, _, steps = fit(side, x, c["y"])
            losses = (run["_losses"].jax_side if side == "jax" else run["_losses"].port)(
                dtype, head, c["first_batch"])
            s = head_summary(head, x, c["y"])
            out[dtype][side] = {
                "w_norm": s["w_norm"], "median_abs_logit": s["median_abs_logit"],
                "lbfgs_steps": steps, **evaluate(side, head, x, c["y"], x_ev, c["y_ev"]),
                "first_batch": dict(zip(LOSS_KEYS, losses.tolist()))}
        out[dtype]["l_out_port_over_jax"] = (out[dtype]["port"]["first_batch"]["l_out"]
                                             / out[dtype]["jax"]["first_batch"]["l_out"])
    out["jax_l_out_bf16_over_f32"] = (out["bfloat16"]["jax"]["first_batch"]["l_out"]
                                      / out["float32"]["jax"]["first_batch"]["l_out"])
    return out


# ---------------------------------------------------------------------------
# tier-1: tiny geometry, training rows fewer than the hidden width
# ---------------------------------------------------------------------------

TINY_N_TRAIN, TINY_N_EVAL, TINY_BATCH, TINY_HIDDEN = 3, 2, 4, 64


def tiny_configs():
    unet = dict(freq_bins=64, frames=24, base_channels=4)
    emb = dict(hidden_size=TINY_HIDDEN, num_layers=2, **PROTOCOL_EMBEDDER)
    jcfg = JPipelineConfig(audio=JAudio(clip_seconds=0.5), unet=JUNet(**unet),
                           embedder=dataclasses.replace(JEmbedder.tiny(), **emb))
    tcfg = tc.PipelineConfig(audio=tc.AudioConfig(clip_seconds=0.5), unet=tc.UNetConfig(**unet),
                             embedder=dataclasses.replace(tc.EmbedderConfig.tiny(), **emb))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def tiny_run():
    return stages(*tiny_configs(), TINY_N_TRAIN, TINY_N_EVAL, TINY_BATCH)


def test_regime_is_the_protocols(tiny_run):
    """Fewer training rows than features (52 of 65 rows, 64 features), and
    a separable corpus: JAX's f32 head's median |logit| on its training
    rows is large (measured 11.9; the protocol's 35-44)."""
    s = tiny_run["float32"]["stage_3"]["jax"]
    assert s["train_rows"] < s["features"] == TINY_HIDDEN, s
    assert s["median_abs_logit"] > 10.0, s


def test_corpora_match_jax(tiny_run):
    dev = tiny_run["stage_1"]
    assert stage_1_holds(dev), dev


@pytest.mark.parametrize("dtype", DTYPES)
def test_embeddings_match_jax(tiny_run, dtype):
    dev = tiny_run[dtype]["stage_2"]
    assert dev["holds"], dev


@pytest.mark.parametrize("dtype", DTYPES)
def test_fit_on_jax_embeddings_matches_jax(tiny_run, dtype):
    dev = tiny_run[dtype]["stage_3"]
    assert dev["holds"], (dev["port_vs_jax"], dev["spread_bar"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_head_metrics_match_jax(tiny_run, dtype):
    dev = tiny_run[dtype]["stage_4"]
    assert dev["holds"], dev


@pytest.mark.parametrize("dtype", DTYPES)
def test_first_losses_with_jax_head_match_jax(tiny_run, dtype):
    dev = tiny_run[dtype]["stage_5"]
    assert dev["holds"], dev


# ---------------------------------------------------------------------------
# script mode: the protocol's width on the CPU
# ---------------------------------------------------------------------------


def public(d):
    """The run's results without the state kept for the chain."""
    if isinstance(d, dict):
        return {k: public(v) for k, v in d.items() if not str(k).startswith("_")}
    return d


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--n-train", type=int, default=32)
    ap.add_argument("--n-eval", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4,
                    help="the embed's and the first training batch's clips (the protocol's 16)")
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    t0 = time.perf_counter()
    tcfg = tcl.anyband_protocol_config()
    tcfg = tcfg.replace(embedder=dataclasses.replace(tcfg.embedder, num_layers=args.layers))
    jcfg = JPipelineConfig(embedder=JEmbedder(**{**PROTOCOL_EMBEDDER, "dtype": "bfloat16",
                                                 "num_layers": args.layers}),
                           train=JTrain(model_lr=tcfg.train.model_lr))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    run = stages(jcfg, tcfg, args.n_train, args.n_eval, args.batch)
    t_stages = time.perf_counter() - t0
    out = {"args": vars(args), "hidden": tcfg.embedder.hidden_size, **public(run),
           "stage_1_holds": stage_1_holds(run["stage_1"])}
    out["stage_3_port_with_jax_loss_form"] = loss_form_dev(run)
    out["chain"] = chain(run)
    out["stages_s"], out["wall_s"] = t_stages, time.perf_counter() - t0
    out["peak_rss_gib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(json.dumps(out, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
