"""PyTorch port: the anyband protocol's training step on the JAX package's
own seed-0 weights, held against JAX's `make_train_step`, step by step.

The port starts from `init_params(PRNGKey(0))` replayed by
`reference_draw.jax_init_params` and loaded by `convert.load_jax_params`;
JAX from its own draw (here from the replay's tree, which
tests/test_torch_reference_draw.py holds equal to it). Both take one
detector head (a seeded direction of norm `HEAD_NORM`, the scale of the
protocol's fitted heads) and the first training clips of the seed-0 anyband
corpus, with the protocol's switches (`scan_layers`, remat "dots"). The
port takes its steps; before each, JAX takes one step from the port's state
(UNet parameters, running statistics, loss weights, both optimisers'
moments), so every step is held on the same inputs and differences do not
compound. Per step: the four losses (total, l_in, l_out, l1) and the loss
weights; and the new UNet parameters, each within 2.1 learning rates
(Adam's first steps move a parameter by about one lr whatever its
gradient's size, so a gradient near 0 may flip) and on average within
`UPDATE_MEAN` lr (measured at tiny width: 6e-4 to 1.5e-3 in f32, 2.6e-3 to
8.5e-3 in bf16; 0.39 to 0.54 when the moments are not carried over). With the embedder in f32, each loss within 1e-4 relative of JAX's
(or 1e-5 absolute near 0); in bf16, JAX compiled with every bf16 rounding
kept, the port's deviation at most half JAX's own bf16-vs-f32 deviation
from the same state, or that f32 bar, whichever is larger
(`test_protocol_switches_loop_matches_jax`'s bar).

    python -m tests.test_torch_protocol_step [--layers 2] [--clips 2] [--steps 8]

runs the same at the protocol's width (`closed_loop.anyband_protocol_config()`:
hidden 1920, 16 heads, 5 s clips) on the CPU, from JAX's own draw, with its
depth and batch cut to `--layers` and `--clips` (about 7 GB at the
defaults), and prints one JSON line: each precision's losses per step on
both sides and their deviations.
"""

import argparse
import copy
import dataclasses
import importlib
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from xai_audio_deepfakes_tpu.config import AudioConfig as JAudio
from xai_audio_deepfakes_tpu.config import EmbedderConfig as JEmbedder
from xai_audio_deepfakes_tpu.config import PipelineConfig as JPipelineConfig
from xai_audio_deepfakes_tpu.config import TrainConfig as JTrain
from xai_audio_deepfakes_tpu.config import UNetConfig as JUNet
from xai_audio_deepfakes_tpu.pipeline.core import ADDvisorPipeline as JPipeline
from xai_audio_deepfakes_tpu_torch import config as tc
from xai_audio_deepfakes_tpu_torch.convert import load_jax_params, unet_variables_to_jax
from xai_audio_deepfakes_tpu_torch.data.synthetic import make_anyband_corpus
from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline
from xai_audio_deepfakes_tpu_torch.reference_draw import jax_init_params
from xai_audio_deepfakes_tpu_torch.train.train_addvisor import init_train_state, make_train_step

j_train = importlib.import_module("xai_audio_deepfakes_tpu.train.train_addvisor")

HEAD_NORM = 64.0
UPDATE_MEAN, UPDATE_MAX = 0.02, 2.1
F32_REL, F32_ABS = 1e-4, 1e-5
PROTOCOL_EMBEDDER = dict(scan_layers=True, remat=True, remat_policy="dots")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Training steps on several xdist workers: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def with_dtype(jcfg, tcfg, dtype: str):
    return (jcfg.replace(embedder=dataclasses.replace(jcfg.embedder, dtype=dtype)),
            tcfg.replace(embedder=dataclasses.replace(tcfg.embedder, dtype=dtype)))


def protocol_clips(tcfg, n: int) -> np.ndarray:
    """The first `n` manipulated training clips of the seed-0 anyband corpus
    (the protocol's first draw; noise rms 1.0)."""
    _, manip, _ = make_anyband_corpus(np.random.default_rng(0), max(n, 2),
                                      tcfg.audio.num_samples, tcfg.stft, noise_rms=1.0,
                                      device="cpu")
    return manip[:n]


def head(hidden: int) -> dict:
    w = np.random.default_rng(1).standard_normal(hidden)
    return {"weight": (w * HEAD_NORM / np.linalg.norm(w)).astype(np.float32)[:, None],
            "bias": np.zeros(1, np.float32)}


class JaxStep:
    """JAX's `make_train_step` on `params` and `logreg`, compiled with every
    bf16 rounding kept: called with the port's train state and a batch, it
    takes one step from that state -> (4 losses + 3 w, the new UNet
    parameters)."""

    def __init__(self, jcfg, params: dict, logreg: dict):
        jpipe = JPipeline(jcfg)
        params = jax.tree.map(jnp.asarray, {**params, "logreg": logreg})
        tx_m, tx_w = j_train.make_optimizers(jcfg)
        self.init = j_train.init_train_state(jpipe, params, tx_m, tx_w)
        self.frozen = {"encoder": params["encoder"], "logreg": params["logreg"]}
        self.step, self.compiled = j_train.make_train_step(jpipe, tx_m, tx_w), None

    def __call__(self, state, wav) -> tuple[np.ndarray, dict]:
        args = (port_state_to_jax(state, self.init), self.frozen, jnp.asarray(wav))
        self.compiled = self.compiled or jax.jit(self.step).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})
        new, aux = self.compiled(*args)
        vec = np.concatenate([np.asarray(aux["loss_vec"], np.float64),
                              np.asarray(aux["w"], np.float64)])
        return vec, jax.tree.map(np.asarray, new.unet_params)


def port_state_to_jax(state, init):
    """The port's train state, Adam's moments included, as JAX's; before the
    first step JAX's own `init`, whose moments are zeros."""
    if state.step == 0:
        return init
    clone = copy.deepcopy(state.decoder)

    def moments(key: str) -> dict:  # copied out: the clone's memory is reused
        with torch.no_grad():
            for p, q in zip(state.decoder.parameters(), clone.parameters()):
                q.copy_(state.opt_model.state[p][key])
        return jax.tree.map(jnp.array, unet_variables_to_jax(clone)["params"])

    count = jnp.asarray(state.step, jnp.int32)

    def adam(mu, nu):
        return (optax.ScaleByAdamState(count, mu, nu), optax.EmptyState())

    w_moments = {k: jnp.array(v.numpy()) for k, v in state.opt_w.state[state.w_raw].items()}
    variables = jax.tree.map(jnp.asarray, unet_variables_to_jax(state.decoder))
    return init._replace(
        unet_params=variables["params"], unet_batch_stats=variables["batch_stats"],
        w_raw=jnp.asarray(state.w_raw.detach().numpy()),
        opt_model=adam(moments("exp_avg"), moments("exp_avg_sq")),
        opt_w=adam(w_moments["exp_avg"], w_moments["exp_avg_sq"]), step=count)


def compare(jcfg, tcfg, clips: int, steps: int, jax_draw: bool = False) -> dict:
    """The port's steps on the seed-0 clips, `clips` a batch, in f32 and in
    bf16, and JAX's step from the port's state before each (in bf16 also
    JAX's f32 step from it, for JAX's own bf16-vs-f32 deviation). JAX's
    weights are its own `init_params(PRNGKey(0))` with `jax_draw`, else the
    replay. -> per precision, [steps, 4 losses + 3 w] for "port", "jax"
    (and "jax_f32"), and "update_over_lr": per step, the mean and the
    largest distance between the two sides' new UNet parameters over the
    learning rate."""
    replay = jax_init_params(tcfg, 0, device="cpu")
    params = jax.jit(JPipeline(jcfg).init_params)(jax.random.PRNGKey(0)) if jax_draw else replay
    replay, params = ({k: tree[k] for k in ("encoder", "unet")} for tree in (replay, params))
    wavs = protocol_clips(tcfg, clips * steps)
    batches = [wavs[i * clips:(i + 1) * clips] for i in range(steps)]
    logreg = head(tcfg.embedder.hidden_size)
    jax_step = {dtype: JaxStep(with_dtype(jcfg, tcfg, dtype)[0], params, logreg)
                for dtype in ("float32", "bfloat16")}
    runs = {}
    for dtype in ("float32", "bfloat16"):
        pipe = ADDvisorPipeline(with_dtype(jcfg, tcfg, dtype)[1], device="cpu", seed=5)
        load_jax_params(pipe, {**replay, "logreg": logreg})
        state, step = init_train_state(pipe), make_train_step(pipe)
        sides = {"port": [], "jax": [], "update_over_lr": []}
        if dtype == "bfloat16":
            sides["jax_f32"] = []
        for wav in batches:
            vec, unet = jax_step[dtype](state, wav)
            sides["jax"].append(vec)
            if dtype == "bfloat16":
                sides["jax_f32"].append(jax_step["float32"](state, wav)[0])
            _, aux = step(state, wav)
            sides["port"].append(np.concatenate([aux["loss_vec"].double().numpy(),
                                                 aux["w"].double().numpy()]))
            d = np.concatenate([np.abs(a - b).ravel() for a, b in zip(
                jax.tree.leaves(unet_variables_to_jax(state.decoder)["params"]),
                jax.tree.leaves(unet))]) / tcfg.train.model_lr
            sides["update_over_lr"].append([float(d.mean()), float(d.max())])
        runs[dtype] = {k: np.array(v) for k, v in sides.items()}
    return runs


def f32_bar(want: np.ndarray) -> np.ndarray:
    return np.maximum(F32_REL * np.abs(want), F32_ABS)


def tiny_configs():
    unet = dict(freq_bins=64, frames=24, base_channels=4)
    jcfg = JPipelineConfig(audio=JAudio(clip_seconds=0.5), unet=JUNet(**unet),
                           embedder=dataclasses.replace(JEmbedder.tiny(), **PROTOCOL_EMBEDDER))
    tcfg = tc.PipelineConfig(audio=tc.AudioConfig(clip_seconds=0.5), unet=tc.UNetConfig(**unet),
                             embedder=dataclasses.replace(tc.EmbedderConfig.tiny(),
                                                          **PROTOCOL_EMBEDDER))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def tiny_runs():
    return compare(*tiny_configs(), clips=2, steps=3)


def assert_updates(update_over_lr: np.ndarray) -> None:
    assert (update_over_lr[:, 0] <= UPDATE_MEAN).all(), update_over_lr
    assert (update_over_lr[:, 1] <= UPDATE_MAX).all(), update_over_lr


def test_f32_steps_on_the_replayed_draw_match_jax(tiny_runs):
    run = tiny_runs["float32"]
    err = np.abs(run["port"] - run["jax"])
    assert (err <= f32_bar(run["jax"])).all(), err
    assert_updates(run["update_over_lr"])


def test_bf16_steps_on_the_replayed_draw_match_jax(tiny_runs):
    run = tiny_runs["bfloat16"]
    err, dev = np.abs(run["port"] - run["jax"]), np.abs(run["jax"] - run["jax_f32"])
    assert (err <= np.maximum(0.5 * dev, f32_bar(run["jax"]))).all(), (err, dev)
    assert_updates(run["update_over_lr"])


def max_rel(a: np.ndarray, b: np.ndarray) -> list:
    """Per column, the largest |a - b| / max(|b|, F32_ABS) over the steps."""
    return (np.abs(a - b) / np.maximum(np.abs(b), F32_ABS)).max(axis=0).tolist()


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--clips", type=int, default=2)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    from xai_audio_deepfakes_tpu_torch.train.closed_loop import anyband_protocol_config

    tcfg = anyband_protocol_config()
    tcfg = tcfg.replace(embedder=dataclasses.replace(tcfg.embedder, num_layers=args.layers))
    jcfg = JPipelineConfig(embedder=JEmbedder(**{**PROTOCOL_EMBEDDER, "dtype": "bfloat16",
                                                 "num_layers": args.layers}),
                           train=JTrain(model_lr=tcfg.train.model_lr))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    runs = compare(jcfg, tcfg, args.clips, args.steps, jax_draw=True)
    out = {"layers": args.layers, "clips": args.clips, "steps": args.steps,
           "hidden": tcfg.embedder.hidden_size,
           "columns": ["loss", "l_in", "l_out", "l1", "w0", "w1", "w2"]}
    for dtype, run in runs.items():
        out[dtype] = {k: v.tolist() for k, v in run.items()}
        out[dtype]["port_vs_jax_max_rel"] = max_rel(run["port"], run["jax"])
    f32, bf16 = runs["float32"], runs["bfloat16"]
    out["bfloat16"]["jax_bf16_vs_f32_max_rel"] = max_rel(bf16["jax"], bf16["jax_f32"])
    out["f32_within_bar"] = bool((np.abs(f32["port"] - f32["jax"]) <= f32_bar(f32["jax"])).all())
    out["updates_within_bar"] = {dtype: bool((run["update_over_lr"][:, 0] <= UPDATE_MEAN).all()
                                             and (run["update_over_lr"][:, 1] <= UPDATE_MAX).all())
                                 for dtype, run in runs.items()}
    out["bf16_within_bar"] = bool((np.abs(bf16["port"] - bf16["jax"]) <= np.maximum(
        0.5 * np.abs(bf16["jax"] - bf16["jax_f32"]), f32_bar(bf16["jax"]))).all())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
