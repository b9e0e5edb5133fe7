"""PyTorch port, the rest of training and the closed loop: asynchronous
checkpoints, the epoch record finalised one epoch late, `artifact_fn`, the
`target_quant="int8"` and bf16-UNet training steps, `evaluate_explanations`
and `run_closed_loop` against the JAX package (with the anyband protocol's
embedder switches, in f32, and its training replayed with the bf16
embedder), the port's own tiny anyband loop, the band probe and the PNG
writers, on the CPU at tiny geometry.

Bars: a resumed run bit for bit; records equal but for `sec`; a training
step at `tests/test_torch_train.py`'s bars (the bf16 UNet's at multiples of
JAX's own bf16-vs-f32 deviation); `evaluate_explanations` on the same
weights and clips: masks 1e-5, probabilities 1e-4, localisation IoUs equal
and means 1e-6; `run_closed_loop`: the same clips and bands (one seed, the
same draws), epoch losses within 1e-4 relative (Adam moves a parameter whose
gradient is zero up to rounding by +-lr in either framework, and later steps
carry that), and in the bf16 replay within half JAX's own bf16-vs-f32
deviation or that bar; the probe's reports equal and its fit's objective
within 1e-6 relative of JAX's.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_audio_deepfakes_tpu import config as jc
from xai_audio_deepfakes_tpu.models.logreg import LogReg
from xai_audio_deepfakes_tpu.pipeline.core import ADDvisorPipeline as JPipeline
from xai_audio_deepfakes_tpu.train import band_probe as jbp
from tests.test_pipeline import tiny_config
from tests.test_torch_bf16 import _strict
from tests.test_torch_models import TINY_UNET, random_params
from tests.test_torch_train import LR, assert_trees_close, make_jax_params
from xai_audio_deepfakes_tpu_torch import config as tc
from xai_audio_deepfakes_tpu_torch.convert import load_jax_params, train_state_to_jax
from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline
from xai_audio_deepfakes_tpu_torch.train import artifacts, checkpoints
from xai_audio_deepfakes_tpu_torch.train import band_probe as tbp
from xai_audio_deepfakes_tpu_torch.train import closed_loop as tcl
from xai_audio_deepfakes_tpu_torch.train.train_addvisor import (
    init_train_state,
    make_train_step,
    train_addvisor,
)

# the package re-exports functions under their modules' names
jcl = importlib.import_module("xai_audio_deepfakes_tpu.train.closed_loop")
j_train = importlib.import_module("xai_audio_deepfakes_tpu.train.train_addvisor")

BW, FMAX = 200.0, 800.0  # tests/test_closed_loop.py's tiny grid: 4 bands in the 64-bin crop
LOOP = dict(seed=0, n_train=8, n_eval=4, epochs=2, batch_size=4, noise_rms=0.8, anyband=True,
            band_width=BW, f_max=FMAX)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Training steps on several xdist workers: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(unet_dtype: str = "float32", **train) -> tc.PipelineConfig:
    """tests/test_pipeline.py::tiny_config in the port's config."""
    return tc.PipelineConfig(
        audio=tc.AudioConfig(clip_seconds=0.5), embedder=tc.EmbedderConfig.tiny(),
        unet=tc.UNetConfig(**TINY_UNET, dtype=unet_dtype), train=tc.TrainConfig(**train))


def _wavs(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, 8000)).astype(np.float32) * 0.1


# ---------------------------------------------------------------------------
# the epoch loop: records one epoch late, artifact_fn, async checkpoints
# ---------------------------------------------------------------------------

BATCHES = [_wavs(2, s) for s in (11, 12, 13, 14)]  # two epochs of two steps


def _epochs(e: int):
    return BATCHES[2 * e:2 * e + 2]


def test_records_and_artifacts_equal_the_synchronous_loop():
    """The loop's records equal those of the same steps taken one by one
    with the host waiting at every boundary, in everything but `sec`, and
    `artifact_fn` is called once per epoch, on its first step, with that
    step's first mask."""
    records, arts = [], []
    pipe = ADDvisorPipeline(tiny(), device="cpu", seed=1)
    epoch = iter(range(2))
    train_addvisor(pipe, batches=lambda: _epochs(next(epoch)), num_epochs=2,
                   log_fn=records.append,
                   artifact_fn=lambda e, mask, aux: arts.append((e, mask.clone(), aux["loss"])))

    ref = ADDvisorPipeline(tiny(), device="cpu", seed=1)
    state, step = init_train_state(ref), make_train_step(ref)
    want, first = [], []
    for e in range(2):
        vecs = []
        for i, wav in enumerate(_epochs(e)):
            _, aux = step(state, wav)
            vecs.append(aux["loss_vec"])
            if i == 0:
                first.append(aux["mask_first"])
        sums = torch.stack(vecs).double().sum(dim=0)
        want.append({"epoch": e + 1, "loss": float(sums[0]) / 2, "l_in": float(sums[1]) / 2,
                     "l_out": float(sums[2]) / 2, "l1": float(sums[3]) / 2,
                     "w": aux["w"].tolist()})
    assert [{k: v for k, v in r.items() if k != "sec"} for r in records] == want
    assert all(r["sec"] > 0 for r in records)
    assert [e for e, _, _ in arts] == [0, 1]
    for (_, mask, _), ref_mask in zip(arts, first):
        assert torch.equal(mask, ref_mask)


@pytest.mark.parametrize("bad_epoch", [0, 1])
def test_nan_guard_pins_step_with_epoch_fold(bad_epoch):
    """With the probes off, the fold still names the failing step: an
    earlier epoch's when it is finalised one epoch late, the last epoch's
    when the loop drains (the port of
    tests/test_train.py::test_nan_guard_pins_step_with_epoch_fold)."""
    bad = BATCHES[0].copy()
    bad[0, 0] = np.nan
    batches = [BATCHES[0], BATCHES[1]] * 2
    batches[2 * bad_epoch + 1] = bad
    pipe = ADDvisorPipeline(tiny(nan_check_every=0), device="cpu", seed=1)
    epoch = iter(range(2))
    with pytest.raises(FloatingPointError, match=f"epoch {bad_epoch + 1} step 1"):
        train_addvisor(pipe, batches=lambda: batches[2 * next(epoch):][:2], num_epochs=2)


def _flat(sd, prefix=""):
    out = {}
    for k, v in sd.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_async_checkpoint_resumes_bit_for_bit(tmp_path):
    """Every epoch checkpointed asynchronously: the first epoch's file is
    the state at that epoch's end (the snapshot, not the state the next
    epoch went on to update in place), and a fresh state restored from it
    and trained on the second epoch's batches equals the uninterrupted run
    bit for bit: decoder, running statistics, w_raw, both optimisers."""
    pipe = ADDvisorPipeline(tiny(), device="cpu", seed=1)
    saved = []
    epoch = iter(range(2))
    state = train_addvisor(
        pipe, batches=lambda: _epochs(next(epoch)), num_epochs=2,
        checkpoint_fn=lambda e, snap, loss: saved.append(
            checkpoints.save_checkpoint(str(tmp_path), e, loss, snap, async_save=True)))
    checkpoints.wait_for_saves()
    assert [checkpoints.parse_checkpoint_name(p)[0] for p in saved] == [1, 2]

    other = ADDvisorPipeline(tiny(), device="cpu", seed=99)
    other.encoder.load_state_dict(pipe.encoder.state_dict())
    other.logreg = pipe.logreg
    resumed = checkpoints.restore_checkpoint(saved[0], init_train_state(other))
    assert resumed.step == 2
    resumed = train_addvisor(other, batches=lambda: _epochs(1), num_epochs=1,
                             initial_state=resumed)
    for path in (None, saved[1]):
        a = _flat(state.state_dict() if path is None else checkpoints.load_checkpoint(path))
        b = _flat(resumed.state_dict())
        assert a.keys() == b.keys()
        for key in a:
            same = torch.equal(a[key], b[key]) if isinstance(a[key], torch.Tensor) else (
                a[key] == b[key])
            assert same, key


def test_async_save_copies_a_live_state_once_and_a_snapshot_never(tmp_path, monkeypatch):
    """A live state is copied to the host before `save_checkpoint` returns
    (an in-place update right after it does not reach the file); a
    `HostSnapshot`, already on the host, is written with no second copy."""
    pipe = ADDvisorPipeline(tiny(), device="cpu", seed=1)
    state = init_train_state(pipe)
    snap = checkpoints.HostSnapshot(state)
    copies = []
    to_host = checkpoints.to_host

    def counting(obj, non_blocking=False):
        if isinstance(obj, dict) and "w_raw" in obj:  # a whole state dict, not a recursion
            copies.append(1)
        return to_host(obj, non_blocking)

    monkeypatch.setattr(checkpoints, "to_host", counting)
    want = state.w_raw.detach().clone()
    live = checkpoints.save_checkpoint(str(tmp_path / "live"), 1, 0.5, state, async_save=True)
    with torch.no_grad():
        state.w_raw.add_(1.0)
    assert len(copies) == 1
    from_snap = checkpoints.save_checkpoint(str(tmp_path / "snap"), 1, 0.5, snap, async_save=True)
    assert len(copies) == 1
    checkpoints.wait_for_saves()
    for path in (live, from_snap):
        assert torch.equal(checkpoints.load_checkpoint(path)["w_raw"], want)


def test_failed_async_write_raises_from_wait_for_saves(tmp_path):
    pipe = ADDvisorPipeline(tiny(), device="cpu", seed=1)
    state = init_train_state(pipe)
    blocker = tmp_path / (checkpoints.checkpoint_name(1, 0.5) + ".tmp")
    blocker.mkdir()  # torch.save cannot write its .tmp file over a directory
    checkpoints.save_checkpoint(str(tmp_path), 1, 0.5, state, async_save=True)
    with pytest.raises(RuntimeError, match="Is a directory"):
        checkpoints.wait_for_saves()
    checkpoints.wait_for_saves()  # the failure is raised once


# ---------------------------------------------------------------------------
# the new trainer switches against JAX's make_train_step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    return make_jax_params()


def _jax_step(params, wav, strict=False, unet=None, **train):
    cfg = tiny_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train),
                      unet=dataclasses.replace(cfg.unet, **(unet or {})))
    jpipe = JPipeline(cfg)
    tx_m, tx_w = j_train.make_optimizers(cfg)
    state = j_train.init_train_state(jpipe, params, tx_m, tx_w)
    frozen = {"encoder": params["encoder"], "logreg": params["logreg"]}
    step = j_train.make_train_step(jpipe, tx_m, tx_w)
    if strict:
        return _strict(step, state, frozen, jnp.asarray(wav))
    return jax.jit(step)(state, frozen, jnp.asarray(wav))


def _port_step(params, wav, cfg):
    pipe = ADDvisorPipeline(cfg, device="cpu", seed=4)
    load_jax_params(pipe, params)
    state = init_train_state(pipe)
    _, aux = make_train_step(pipe)(state, wav)
    return state, aux


@pytest.fixture(scope="module")
def int8_reference(jax_params):
    """JAX's step with `target_quant="int8"` and the f32 UNet."""
    return _jax_step(jax_params, _wavs(2, 3), target_quant="int8")


def test_target_quant_int8_step_matches_jax(jax_params, int8_reference):
    """`target_quant="int8"`: the target embed through int8 products of the
    same weights (a second module, no copy), the rest of the step f32. At
    the bars of tests/test_torch_train.py::test_train_step_matches_jax, and
    the int8 target differs from the exact one."""
    wav = _wavs(2, 3)
    ref_state, ref_aux = int8_reference
    state, aux = _port_step(jax_params, wav, tiny(target_quant="int8"))
    for name in ("loss_vec", "mask_first", "w"):
        np.testing.assert_allclose(aux[name].numpy(), np.asarray(ref_aux[name]), atol=1e-5,
                                   err_msg=name)
    mine = train_state_to_jax(state)
    np.testing.assert_allclose(mine["w_raw"], np.asarray(ref_state.w_raw), atol=1e-6)
    assert_trees_close(mine["unet_batch_stats"], ref_state.unet_batch_stats, 1e-5, "batch_stats")
    assert_trees_close(mine["unet_params"], ref_state.unet_params, 2.1 * LR, "params")
    _, exact = _port_step(jax_params, wav, tiny())
    assert not torch.equal(aux["loss_vec"], exact["loss_vec"])


def _leaves(tree) -> np.ndarray:
    return np.concatenate([np.ravel(np.asarray(x)) for x in jax.tree.leaves(tree)])


def test_bf16_unet_step_matches_jax(jax_params, int8_reference):
    """The bf16 UNet trains (here beside the int8 target, `bench.py`'s
    serving pair): the step's first mask, new batch statistics and losses
    against JAX's bf16 step compiled with every bf16 rounding kept, at
    multiples of JAX's own bf16-vs-f32 deviation (the same step with the f32
    UNet): the mask and the statistics' mean deviation at most that mean
    and their largest at most its largest; the four losses at most 4x its
    largest. Training-mode BatchNorm reduces the bf16 activations in f32 in
    each framework's own order, so bf16 roundings flip downstream where the
    serving UNet's fixed statistics flip none (there
    tests/test_torch_bf16.py holds 0.4 of the mean); JAX's own jit and
    strict compilations of this step differ by about 4x its bf16-vs-f32
    loss deviation. Parameters stay f32; the updated ones within 2.1 lr, as
    the f32 step's."""
    wav = _wavs(2, 3)
    ref_state, ref_aux = _jax_step(jax_params, wav, strict=True, unet={"dtype": "bfloat16"},
                                   target_quant="int8")
    f32_state, f32_aux = int8_reference
    state, aux = _port_step(jax_params, wav, tiny("bfloat16", target_quant="int8"))
    mine = train_state_to_jax(state)
    for name, got, want, own in (
            ("mask_first", aux["mask_first"].numpy(), ref_aux["mask_first"],
             f32_aux["mask_first"]),
            ("batch_stats", _leaves(mine["unet_batch_stats"]), _leaves(ref_state.unet_batch_stats),
             _leaves(f32_state.unet_batch_stats))):
        err, dev = np.abs(got - np.asarray(want)), np.abs(np.asarray(want) - np.asarray(own))
        assert err.mean() <= dev.mean() and err.max() <= dev.max(), (name, err.mean(), dev.mean(),
                                                                      err.max(), dev.max())
    err = np.abs(aux["loss_vec"].numpy() - np.asarray(ref_aux["loss_vec"]))
    dev = np.abs(np.asarray(ref_aux["loss_vec"]) - np.asarray(f32_aux["loss_vec"]))
    assert err.max() <= 4 * dev.max(), (err, dev)
    assert all(p.dtype == torch.float32 for p in state.decoder.parameters())
    assert_trees_close(mine["unet_params"], ref_state.unet_params, 2.1 * LR, "params")


# ---------------------------------------------------------------------------
# evaluate_explanations and run_closed_loop against JAX on the same weights
# ---------------------------------------------------------------------------


# the anyband protocol's embedder switches (`anyband_protocol_config`) at tiny
# width; num_layers is the readout layer, as in the flagship truncation, so
# JAX's scanned stack holds just the layers that run
SWITCHES = dict(scan_layers=True, remat=True, remat_policy="dots", num_layers=2)


def _switched(cfg, **embedder):
    return cfg.replace(embedder=dataclasses.replace(cfg.embedder, **SWITCHES, **embedder))


@pytest.fixture(scope="module")
def loops():
    """JAX's and the port's `run_closed_loop` on tests/test_closed_loop.py's
    tiny anyband configuration (lr 3e-3) with the anyband protocol's
    embedder switches in f32 (SWITCHES) and LOOP's size, with the same
    random weights (JAX's `init_params` replaced by numpy draws, which also
    skips its op-by-op initialisers; its jitted explain kept across the
    three evaluations) and JAX's fitted detector head in both
    (the two L-BFGS fits agree to a cosine of 0.999 only). Returns both
    results, each side's first `evaluate_explanations` output (before
    training: same weights, same clips), and what a replay of the training
    needs: the weights, the head and each epoch's batches."""
    jcfg = _switched(tiny_config().replace(train=jc.TrainConfig(model_lr=3e-3)))
    wav = jnp.zeros((1, 8000), jnp.float32)
    mag = jnp.zeros((1, 64, 24), jnp.float32)
    base = JPipeline(jcfg)
    params = {"encoder": random_params(base.encoder.init, jax.random.PRNGKey(0), wav, seed=1),
              "unet": random_params(base.unet.init, jax.random.PRNGKey(0), mag, seed=2),
              "logreg": jax.tree.map(np.asarray, LogReg.init(32, seed=3))}

    jitted: dict = {}

    class FixedInit(JPipeline):
        def init_params(self, rng, with_hifigan=False):
            return jax.tree.map(jnp.asarray, params)

        def jit_explain(self, decoder="unet", masking=None):
            # one compile for the three evaluations, not one each
            key = (decoder, masking)
            if key not in jitted:
                jitted[key] = super().jit_explain(decoder, masking)
            return jitted[key]

    got: dict = {}

    def spy(mod, name, key, fn=None):
        orig = getattr(mod, name)

        def wrapped(*a, **kw):
            out = (fn or orig)(*a, **kw)
            got.setdefault(key, out)
            return out

        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcl, "ADDvisorPipeline", FixedInit)
        mp.setattr(jcl, "train_detector", spy(jcl, "train_detector", "jax_head"))
        mp.setattr(jcl, "evaluate_explanations", spy(jcl, "evaluate_explanations", "jax_before"))
        ref = jcl.run_closed_loop(jcfg, **LOOP)

    head = {k: torch.from_numpy(np.array(v)) for k, v in got["jax_head"][0].items()}
    pipe = ADDvisorPipeline(_switched(tiny(model_lr=3e-3)), device="cpu", seed=7)
    load_jax_params(pipe, params)
    epochs: list = []

    def recording_trainer(pipe, batches, **kw):
        def recorded():
            epochs.append(batches())
            return epochs[-1]

        return tcl.train_addvisor.__wrapped__(pipe, recorded, **kw)

    recording_trainer.__wrapped__ = tcl.train_addvisor
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcl, "train_detector", lambda x, y, **kw: (head, got["jax_head"][1]))
        mp.setattr(tcl, "evaluate_explanations",
                   spy(tcl, "evaluate_explanations", "port_before"))
        mp.setattr(tcl, "train_addvisor", recording_trainer)
        mine = tcl.run_closed_loop(_switched(tiny(model_lr=3e-3)), device="cpu", pipe=pipe,
                                   **LOOP)
    replay = {"params": params, "head": got["jax_head"][0], "batches": epochs, "jcfg": jcfg}
    return ref, mine, got["jax_before"], got["port_before"], replay


def _assert_localization(got: dict, want: dict, mean_tol: float) -> None:
    assert got.keys() == want.keys()
    for key, w in want.items():
        if key == "per_clip":
            continue
        if "iou" in key:
            assert got[key] == w, key
        else:
            assert abs(got[key] - w) <= mean_tol, (key, got[key], w)


def test_evaluate_explanations_matches_jax(loops):
    """Before training: the same weights, head and clips through both
    `evaluate_explanations` (batch 4, anyband scoring)."""
    _, _, ref, mine, _ = loops
    np.testing.assert_allclose(mine["masks"], ref["masks"], atol=1e-5)
    np.testing.assert_allclose(mine["probs"], ref["probs"], atol=1e-4)
    _assert_localization(mine["localization"], ref["localization"], 1e-6)
    for key in ("keep_rate", "flip_rate"):
        assert mine[key] == ref[key], key
    for key, want in ref["metrics"].items():
        assert mine["metrics"][key] == pytest.approx(want, rel=1e-4, abs=1e-4), key


def test_evaluate_explanations_covers_the_tail():
    """n not a multiple of the batch: every clip is scored, the padded tail
    batch gives clip 6 the mask a full batch gives it, and `keep_wavs`
    returns that many waveforms."""
    pipe = ADDvisorPipeline(tiny(), device="cpu", seed=2)
    wavs = _wavs(7, 5)
    res = tcl.evaluate_explanations(pipe, wavs, (350.0, 650.0), tc.MaskingConvention.LINEAR, 4,
                                    keep_wavs=5)
    full = tcl.evaluate_explanations(pipe, wavs, (350.0, 650.0), tc.MaskingConvention.LINEAR, 7)
    assert res["masks"].shape[0] == res["magnitude"].shape[0] == 7
    assert res["relevant_wavs"].shape == (5, 8000) and full["relevant_wavs"] is None
    np.testing.assert_allclose(res["masks"][6], full["masks"][6], atol=1e-5)


def test_run_closed_loop_matches_jax(loops):
    """One seed, the same draws: the evaluation bands, the detector corpus's
    head (injected) and its held-out check, and the epoch records at the
    training-step bars; the returned keys are JAX's."""
    ref, mine, _, _, _ = loops
    assert mine.keys() == ref.keys()
    assert mine["eval_bands_hz"] == ref["eval_bands_hz"]
    np.testing.assert_array_equal(mine["eval_manipulated"].shape, ref["eval_manipulated"].shape)
    np.testing.assert_allclose(mine["eval_manipulated"], ref["eval_manipulated"], atol=2e-4)
    assert mine["detector"] == ref["detector"]
    assert mine["detector_holdout"]["accuracy"] == ref["detector_holdout"]["accuracy"]
    assert [r["epoch"] for r in mine["train_log"]] == [r["epoch"] for r in ref["train_log"]]
    for got, want in zip(mine["train_log"], ref["train_log"]):
        for key in ("loss", "l_in", "l_out", "l1"):
            assert got[key] == pytest.approx(want[key], rel=1e-4), key
        np.testing.assert_allclose(got["w"], want["w"], atol=1e-6)
    for phase in ("before", "after", "after_train"):
        assert mine[phase].keys() == ref[phase].keys(), phase
    assert mine["final_masks"].shape == ref["final_masks"].shape
    np.testing.assert_allclose(mine["final_probs"], ref["final_probs"], atol=1e-2)


def test_protocol_switches_loop_matches_jax(loops):
    """The protocol's training configuration, the bf16 embedder with
    `scan_layers` and remat "dots", over the loop's epochs: `loops`' weights,
    head and batch orders replayed through the port's `train_addvisor` and
    through JAX's step compiled with every bf16 rounding kept. Each epoch
    record's four losses, term by term: the port's deviation from JAX's
    bf16 run at most half JAX's own bf16-vs-f32 deviation (its f32 run of
    the same switches in `loops`) or `test_run_closed_loop_matches_jax`'s
    1e-4 relative, whichever is larger. (Measured: 0.01-0.1x of that
    deviation for the loss and its two classifier terms, where the
    f32-fitted head makes JAX's own bf16 run differ by 0.03-1.6; the l1
    term, a mean of the f32 decoder's mask, 2.6e-6 and 1.9e-5, under the
    relative bar of 4e-5, where JAX's own deviation is 3e-6 and 1e-5. A
    wrong derivative in the bf16 GELU's backward fails it 18-100x.)"""
    ref, _, _, _, replay = loops
    jcfg = replay["jcfg"].replace(
        embedder=dataclasses.replace(replay["jcfg"].embedder, dtype="bfloat16"))
    params = {**replay["params"], "logreg": jax.tree.map(jnp.asarray, replay["head"])}
    tx_m, tx_w = j_train.make_optimizers(jcfg)
    jpipe = JPipeline(jcfg)
    state = j_train.init_train_state(jpipe, params, tx_m, tx_w)
    frozen = {"encoder": params["encoder"], "logreg": params["logreg"]}
    step = j_train.make_train_step(jpipe, tx_m, tx_w)
    compiled, want = None, []
    for batches in replay["batches"]:
        vecs = []
        for wav in batches:
            args = (state, frozen, jnp.asarray(wav))
            compiled = compiled or jax.jit(step).lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
            state, aux = compiled(*args)
            vecs.append(np.asarray(aux["loss_vec"], np.float64))
        want.append(np.mean(vecs, axis=0))

    pipe = ADDvisorPipeline(_switched(tiny(model_lr=3e-3), dtype="bfloat16"), device="cpu",
                            seed=7)
    load_jax_params(pipe, replay["params"])
    pipe.logreg = {k: torch.from_numpy(np.array(v)) for k, v in replay["head"].items()}
    epochs, records = iter(replay["batches"]), []
    train_addvisor(pipe, lambda: next(epochs), num_epochs=len(replay["batches"]),
                   log_fn=records.append)
    keys = ("loss", "l_in", "l_out", "l1")
    got = np.array([[r[k] for k in keys] for r in records])
    f32 = np.array([[r[k] for k in keys] for r in ref["train_log"]])
    want = np.array(want)
    err, dev = np.abs(got - want), np.abs(want - f32)
    assert (err <= np.maximum(0.5 * dev, 1e-4 * np.abs(want))).all(), (err, dev)


def test_anyband_loop_masks_track_per_clip_band():
    """The port's own tiny anyband loop, on its own random weights and its
    own detector fit: the trained masks track each clip's band better than
    the grid's other bands and than the untrained decoder, masks of
    different-band clips differ, and the relevant part keeps the
    detector's call while the complement flips it
    (tests/test_closed_loop.py's claims; there the untrained complement
    does not flip yet, here the port's random decoder flips it from the
    start, so the flip is held as a rate). Smaller than JAX's 24 clips for
    25 epochs at batch 8, and with the unpadded attention
    (`fused_attention=False`): 64 steps at batch 4 take a third of the CPU
    time."""
    cfg = tiny(model_lr=3e-3)
    cfg = cfg.replace(embedder=dataclasses.replace(cfg.embedder, fused_attention=False))
    res = tcl.run_closed_loop(cfg, seed=0, n_train=16, n_eval=8, epochs=16, batch_size=4,
                              noise_rms=0.8, anyband=True, band_width=BW, f_max=FMAX,
                              device="cpu")
    assert res["anyband"] and res["band_hz"] is None and len(res["eval_bands_hz"]) == 8
    before, after = res["before"]["localization"], res["after"]["localization"]
    assert after["own_iou_mean"] > 2 * after["other_iou_mean"]
    assert after["own_iou_mean"] > 1.5 * before["own_iou_mean"]
    assert after["cross_band_pair_iou"] < 0.5
    assert after["mask_std_across_clips"] > 0.01
    assert res["after"]["keep_rate"] >= 0.75 and res["after"]["flip_rate"] >= 0.75
    assert len(res["train_log"]) == 16 and res["state"].step == 64


# ---------------------------------------------------------------------------
# the band probe and the PNG writers
# ---------------------------------------------------------------------------


def test_frame_band_probe_matches_jax():
    """tests/test_band_probe.py's planted signal: the port's report equals
    JAX's, key for key (the split, the frame labels, the vote and the
    shuffle are the same draws and the same arithmetic). Both fits are cut
    to 40 L-BFGS steps here, where the planted classes are separated
    already; the fit at its full length is held below."""
    rng = np.random.default_rng(0)
    n, t, h, k = 48, 12, 24, 4
    cls = rng.integers(0, k, size=n)
    dirs = rng.standard_normal((k, h)).astype(np.float32)
    feats = dirs[cls][:, None, :] + 0.3 * rng.standard_normal((n, t, h)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jbp, tbp):
            mp.setattr(mod, "fit_softmax_probe",
                       functools.partial(mod.fit_softmax_probe, max_iter=40))
        want = jbp.frame_band_probe(feats, cls, k, seed=0)
        got = tbp.frame_band_probe(feats, cls, k, seed=0, device="cpu")
    assert got == want
    assert got["frame_acc"] > 0.9 and got["shuffled_frame_acc"] < 0.5


def test_fit_softmax_probe_matches_jax():
    """Overlapping classes (a finite optimum): the port's L-BFGS and
    `optax.lbfgs` reach the same objective within 1e-6 relative (float64,
    at each side's weights), and their predictions agree on 99% of the
    points."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    y = np.argmax(x @ rng.standard_normal((16, 3)) * 0.7 + rng.gumbel(size=(300, 3)), axis=1)
    want = jbp.fit_softmax_probe(x, y, 3, l2=1e-2)
    got = tbp.fit_softmax_probe(x, y, 3, l2=1e-2, device="cpu")

    def objective(p):
        z = x.astype(np.float64) @ p["weight"] + p["bias"]
        z = z - z.max(axis=1, keepdims=True)
        nll = -(z[np.arange(len(y)), y] - np.log(np.exp(z).sum(axis=1))).sum()
        return nll + 0.5e-2 * (p["weight"].astype(np.float64) ** 2).sum()

    assert objective(got) == pytest.approx(objective(want), rel=1e-6)
    agree = tbp.probe_predict(got, x) == jbp.probe_predict(want, x)
    assert agree.mean() >= 0.99


def test_png_writers(tmp_path):
    """The four writers, fed a torch tensor and numpy arrays, write PNGs."""
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(2)
    paths = [
        artifacts.save_mask_png(torch.rand(64, 24), str(tmp_path / "m.png")),
        artifacts.save_spectrogram_png(rng.uniform(0, 2, (64, 24)), str(tmp_path / "s.png")),
        artifacts.save_waveform_mask_png(rng.uniform(-1, 1, 800), str(tmp_path / "w.png"),
                                         wav=rng.standard_normal(800)),
        artifacts.save_features_png(rng.standard_normal((2, 25, 32)), str(tmp_path / "f.png")),
    ]
    for path in paths:
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
