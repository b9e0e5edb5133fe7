"""PyTorch port, LMAC training: the loss, one whole training step against the
JAX package's `make_train_step` on identical parameters, batch statistics
and batch (tiny geometry, CPU), the epoch loop, the NaN probe, checkpoints
and the prefetcher."""

import dataclasses
import importlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_audio_deepfakes_tpu import config as jc
from xai_audio_deepfakes_tpu.losses import lmac as j_lmac
from xai_audio_deepfakes_tpu.models.logreg import LogReg
from xai_audio_deepfakes_tpu.models.logreg import logreg_apply as j_logreg_apply
from xai_audio_deepfakes_tpu.models.unet import UNetMaskDecoder as JUNet
from xai_audio_deepfakes_tpu.ops.masking import crop_spec as j_crop_spec
from xai_audio_deepfakes_tpu.ops.normalize import zero_mean_unit_var_norm as j_norm
from xai_audio_deepfakes_tpu.pipeline.core import ADDvisorPipeline as JPipeline
from tests.test_pipeline import tiny_config
from tests.test_torch_models import TINY_UNET, random_params
from xai_audio_deepfakes_tpu_torch import config as tc
from xai_audio_deepfakes_tpu_torch.convert import (
    load_jax_params,
    load_unet,
    train_state_to_jax,
    unet_variables_to_jax,
)
from xai_audio_deepfakes_tpu_torch.data.prefetch import prefetch, prefetch_to_device
from xai_audio_deepfakes_tpu_torch.losses import lmac
from xai_audio_deepfakes_tpu_torch.models.unet import UNetMaskDecoder
from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline
from xai_audio_deepfakes_tpu_torch.train import checkpoints
from xai_audio_deepfakes_tpu_torch.train.train_addvisor import (
    init_train_state,
    make_optimizers,
    make_train_step,
    restore_decoder_for_inference,
    train_addvisor,
)

# the package re-exports the function `train_addvisor` under the module's name
j_train = importlib.import_module("xai_audio_deepfakes_tpu.train.train_addvisor")
LR = tc.TrainConfig().model_lr


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 run has several worker processes on a few cores: torch's
    intra-op pool (one thread per core in every worker) then spends its time
    waiting, above all in the backward pass. One thread is enough at these
    sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(**train) -> tc.PipelineConfig:
    """tests/test_pipeline.py::tiny_config's geometry in the port's config."""
    return tc.PipelineConfig(
        audio=tc.AudioConfig(clip_seconds=0.5), embedder=tc.EmbedderConfig.tiny(),
        unet=tc.UNetConfig(**TINY_UNET), train=tc.TrainConfig(**train))


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


def test_loss_and_train_configs_match_jax():
    for mine, ref in ((tc.LossConfig(), jc.LossConfig()), (tc.TrainConfig(), jc.TrainConfig())):
        assert [f.name for f in dataclasses.fields(mine)] == [f.name for f in dataclasses.fields(ref)]
        for f in dataclasses.fields(mine):
            a, b = getattr(mine, f.name), getattr(ref, f.name)
            assert (a.value, type(a).__name__) == (b.value, type(b).__name__) if hasattr(a, "value") else a == b
    assert tc.PipelineConfig().loss == tc.LossConfig() and tc.PipelineConfig().train == tc.TrainConfig()


@pytest.mark.parametrize("changes,raises", [
    (dict(train=tc.TrainConfig(target_quant="int4")), True),
    (dict(embedder=dataclasses.replace(tc.EmbedderConfig.tiny(), remat=True, remat_policy="dots")), False),
    (dict(embedder=dataclasses.replace(tc.EmbedderConfig.tiny(), remat=True)), False),
    (dict(embedder=dataclasses.replace(tc.EmbedderConfig.tiny(), fused_conv=True)), False),
    (dict(train=tc.TrainConfig(target_gelu="tanh")), False),
    (dict(train=tc.TrainConfig(target_quant="int8")), False),
])
def test_training_switches(changes, raises):
    """Every training switch of the JAX package is accepted (target_quant
    "int8" since it was ported); a value that selects no formulation
    raises."""
    cfg = tiny().replace(**changes)
    if raises:
        with pytest.raises(ValueError, match="unknown target quant"):
            tc.check_supported(cfg)
    else:
        tc.check_supported(cfg)


def test_trainer_refuses_the_bf16_unet():
    """The trainer no longer refuses the bf16 UNet: the state keeps f32
    parameters and Adam moments, and a step gives f32 gradients and a
    finite loss (held against JAX in tests/test_torch_closed_loop.py)."""
    pipe = ADDvisorPipeline(tiny().replace(unet=dataclasses.replace(tiny().unet, dtype="bfloat16")),
                            device="cpu")
    state = init_train_state(pipe)
    _, aux = make_train_step(pipe)(state, np.full((2, 8000), 0.01, np.float32))
    assert bool(torch.isfinite(aux["loss_vec"]).all())
    for p in pipe.unet.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32


def test_trainer_defaults_to_cuda_and_refuses_the_feature_decoder():
    """Without CUDA the default pipeline raises; an unknown decoder raises.
    (The feature decoder trains since it was ported:
    tests/test_torch_feat_decoder.py.)"""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ADDvisorPipeline(tiny())
    pipe = ADDvisorPipeline(tiny(), device="cpu")
    for fn in (init_train_state, make_train_step):
        with pytest.raises(ValueError, match="unknown decoder"):
            fn(pipe, decoder="nope")


# ---------------------------------------------------------------------------
# losses/lmac.py
# ---------------------------------------------------------------------------


def test_bce_with_logits_matches_jax(rng):
    logits = rng.standard_normal((7, 1)).astype(np.float32) * 4
    targets = rng.uniform(size=(7, 1)).astype(np.float32)
    got = lmac.bce_with_logits(torch.from_numpy(logits), torch.from_numpy(targets))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_lmac.bce_with_logits(logits, targets)), atol=1e-6)
    want = torch.nn.functional.binary_cross_entropy_with_logits(
        torch.from_numpy(logits), torch.from_numpy(targets))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("freeze_last", [False, True])
def test_renormalize_w_matches_jax(rng, freeze_last):
    w_raw = rng.standard_normal(3).astype(np.float32) + np.float32(1.5)
    got = lmac.renormalize_w(torch.from_numpy(w_raw), freeze_last=freeze_last)
    want = np.asarray(j_lmac.renormalize_w(jnp.asarray(w_raw), freeze_last=freeze_last))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    w = lmac.softplus_weights(got)
    if freeze_last:
        assert got[-1].item() == w_raw[-1]  # bit for bit
        np.testing.assert_allclose(float(w[:-1].sum()), 2.0, atol=1e-5)
    else:
        np.testing.assert_allclose(float(w.sum()), 3.0, atol=1e-5)


@pytest.mark.parametrize("masking,reg_w_tv,l1_scale", [("linear", 0.0, None), ("log1p", 0.01, 2.5)])
def test_lmac_loss_matches_jax(rng, masking, reg_w_tv, l1_scale):
    """The loss with a stand-in classifier (a fixed linear map of the
    waveform) and the real iSTFT: total, the three terms and w, atol 1e-6
    (the TV term sums 3000 differences: 1e-5 on the total there)."""
    b, f, t, n = 2, 513, 25, 8000
    mask = rng.uniform(size=(b, 64, 24)).astype(np.float32)
    mag = rng.uniform(0, 2, (b, f, t)).astype(np.float32)
    phase = rng.uniform(-3, 3, (b, f, t)).astype(np.float32)
    class_pred = rng.uniform(size=(b, 1)).astype(np.float32)
    w_raw = np.asarray([3.0, 0.5, 3.0], np.float32)
    proj = (rng.standard_normal((n, 1)) / 30).astype(np.float32)
    jpipe = JPipeline(tiny_config())
    jcfg = jc.LossConfig(masking=jc.MaskingConvention(masking), reg_w_tv=reg_w_tv)
    want = j_lmac.lmac_loss(
        jnp.asarray(w_raw), jnp.asarray(mask), jnp.asarray(mag), jnp.asarray(phase),
        jnp.asarray(class_pred), lambda x: x @ proj, jpipe.istft, jcfg, l1_scale=l1_scale)
    pipe = ADDvisorPipeline(tiny(), device="cpu")
    cfg = tc.LossConfig(masking=tc.MaskingConvention(masking), reg_w_tv=reg_w_tv)
    got = lmac.lmac_loss(
        *(torch.from_numpy(a) for a in (w_raw, mask, mag, phase, class_pred)),
        lambda x: x @ torch.from_numpy(proj), pipe.istft_stage, cfg, l1_scale=l1_scale)
    for g, w, name in zip(got, want, ("total", "losses", "w")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5 if reg_w_tv else 1e-6,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# UNet in training mode, the reverse bridge
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    return make_jax_params()


def make_jax_params() -> dict:
    """Random numpy weights for the tiny pipeline, in the JAX tree."""
    cfg = tiny_config()
    jpipe = JPipeline(cfg)
    wav = jnp.zeros((1, cfg.audio.num_samples), jnp.float32)
    mag = jnp.zeros((1, cfg.unet.freq_bins, cfg.unet.frames), jnp.float32)
    return {
        "encoder": random_params(jpipe.encoder.init, jax.random.PRNGKey(0), wav, seed=1),
        "unet": random_params(jpipe.unet.init, jax.random.PRNGKey(0), mag, seed=2),
        "logreg": jax.tree.map(np.asarray, LogReg.init(cfg.embedder.hidden_size, seed=3)),
    }


def assert_trees_close(got, want, atol, what):
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_w = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, want)))
    assert flat_g.keys() == flat_w.keys(), what
    for path, w in flat_w.items():
        np.testing.assert_allclose(flat_g[path], w, atol=atol,
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


def test_unet_training_mode_matches_flax(rng, jax_params):
    """train=True: the mask from batch statistics (1e-5) and the new running
    statistics (1e-5). flax keeps the BIASED batch variance in its running
    variance; stock nn.BatchNorm2d folds the unbiased one, which is off by
    momentum * var / (n - 1) and fails this bar (shown below)."""
    mag = rng.uniform(0, 2, (2, 64, 24)).astype(np.float32)
    variables = jax_params["unet"]
    ref_mask, updates = JUNet(jc.UNetConfig(**TINY_UNET)).apply(
        variables, jnp.asarray(mag), train=True, mutable=["batch_stats"])
    model = UNetMaskDecoder(tc.UNetConfig(**TINY_UNET))
    load_unet(model, variables)
    model.train()
    mask = model(torch.from_numpy(mag))
    np.testing.assert_allclose(mask.detach().numpy(), np.asarray(ref_mask), atol=1e-5)
    got = unet_variables_to_jax(model)
    assert_trees_close(got["batch_stats"], updates["batch_stats"], 1e-5, "batch_stats")
    assert_trees_close(got["params"], variables["params"], 0, "params")  # the bridge inverts exactly

    stock = UNetMaskDecoder(tc.UNetConfig(**TINY_UNET))
    for name, mod in list(stock.named_modules()):
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.__class__ = torch.nn.BatchNorm2d
    load_unet(stock, variables)
    stock.train()
    stock(torch.from_numpy(mag))
    worst = max(
        float(np.abs(a - np.asarray(b)).max())
        for a, b in zip(jax.tree.leaves(unet_variables_to_jax(stock)["batch_stats"]),
                        jax.tree.leaves(updates["batch_stats"])))
    assert worst > 1e-5


# ---------------------------------------------------------------------------
# one whole training step against the JAX step
# ---------------------------------------------------------------------------


def jax_step_and_grads(params, wav, embedder=None, **train):
    """The JAX package's jitted step on `params`, and the gradients of its
    loss (rebuilt from the same public functions the step calls)."""
    cfg = tiny_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train),
                      embedder=dataclasses.replace(cfg.embedder, **(embedder or {})))
    jpipe = JPipeline(cfg)
    tx_m, tx_w = j_train.make_optimizers(cfg)
    state = j_train.init_train_state(jpipe, params, tx_m, tx_w)
    frozen = {"encoder": params["encoder"], "logreg": params["logreg"]}
    new_state, aux = jax.jit(j_train.make_train_step(jpipe, tx_m, tx_w))(state, frozen, wav)

    def classify(x):
        feats = jpipe.encoder.apply(params["encoder"], j_norm(x))
        return j_logreg_apply(params["logreg"], jnp.mean(feats, axis=1))[0]

    def loss_fn(dec_params, w_raw):
        _, _, mag, phase = jpipe.spectrogram(wav)
        class_pred = jax.nn.sigmoid(jax.lax.stop_gradient(classify(wav)))
        mask, _ = jpipe.unet.apply(
            {"params": dec_params, "batch_stats": params["unet"]["batch_stats"]},
            j_crop_spec(mag, cfg.unet.freq_bins, cfg.unet.frames), train=True,
            mutable=["batch_stats"])
        return j_lmac.lmac_loss(w_raw, mask, mag, phase, class_pred, classify, jpipe.istft,
                                cfg.loss)[0]

    grads = jax.jit(jax.grad(loss_fn, argnums=(0, 1)))(params["unet"]["params"], state.w_raw)
    return new_state, aux, grads


def decoder_grads_as_jax(model: UNetMaskDecoder) -> dict:
    """The decoder's .grad tensors in the JAX tree's layout: the bridge's
    layout rules are linear, so they map gradients as they map weights."""
    holder = UNetMaskDecoder(model.cfg)
    holder.load_state_dict(model.state_dict())
    with torch.no_grad():
        for p, src in zip(holder.parameters(), model.parameters()):
            p.copy_(src.grad)
    return unet_variables_to_jax(holder)["params"]


@pytest.mark.parametrize("freeze_l1_weight", [False, True])
def test_train_step_matches_jax(jax_params, freeze_l1_weight):
    """Identical parameters, batch statistics and batch through both steps:
    the total and the three losses (1e-5), the decoder's gradients (rtol 1e-3
    with an atol of 1e-4 of the tree's largest gradient), the w_raw gradient
    and the updated w_raw (1e-6), the new batch statistics (1e-5) and the
    updated decoder parameters.

    The first Adam step moves every parameter by lr * g / (|g| + 1e-8), that
    is by about lr whatever |g| is: a gradient that is zero up to rounding
    (a conv bias in front of a BatchNorm) may take either sign, so a
    parameter may differ by 2 * lr. The bar is 2.1 * lr on every entry, and
    1e-7 on all but 1% of the entries of the conv kernels."""
    check_train_step_against_jax(jax_params, freeze_l1_weight=freeze_l1_weight)


def check_train_step_against_jax(jax_params, embedder=None, freeze_l1_weight=False):
    """`test_train_step_matches_jax`'s comparison, with `embedder` changes
    to the EmbedderConfig of both sides."""
    wav = np.random.default_rng(3).standard_normal((2, 8000)).astype(np.float32) * 0.1
    ref_state, ref_aux, (ref_g, ref_gw) = jax_step_and_grads(
        jax_params, jnp.asarray(wav), embedder, freeze_l1_weight=freeze_l1_weight)

    cfg = tiny(freeze_l1_weight=freeze_l1_weight)
    cfg = cfg.replace(embedder=dataclasses.replace(cfg.embedder, **(embedder or {})))
    pipe = ADDvisorPipeline(cfg, device="cpu", seed=4)
    load_jax_params(pipe, jax_params)
    enc_before = [p.detach().clone() for p in pipe.encoder.parameters()]
    state = init_train_state(pipe)
    state2, aux = make_train_step(pipe)(state, wav)
    assert state2 is state and state.step == 1 and not pipe.unet.training

    for name in ("loss", "l_in", "l_out", "l1"):
        np.testing.assert_allclose(aux[name].numpy(), np.asarray(ref_aux[name]), atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(aux["loss_vec"].numpy(), np.asarray(ref_aux["loss_vec"]), atol=1e-5)
    np.testing.assert_allclose(aux["mask_first"].numpy(), np.asarray(ref_aux["mask_first"]), atol=1e-5)

    grads = decoder_grads_as_jax(pipe.unet)
    scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(ref_g))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(grads), jax.tree.leaves(ref_g)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))
    gw = np.asarray(ref_gw).copy()
    if freeze_l1_weight:
        gw[-1] = 0.0  # the step zeroes it before the optimiser
    np.testing.assert_allclose(state.w_raw.grad.numpy(), gw, atol=1e-6)

    mine = train_state_to_jax(state)
    np.testing.assert_allclose(mine["w_raw"], np.asarray(ref_state.w_raw), atol=1e-6)
    np.testing.assert_allclose(aux["w"].numpy(), np.asarray(ref_aux["w"]), atol=1e-6)
    if freeze_l1_weight:
        assert mine["w_raw"][-1] == np.float32(3.0)
    assert_trees_close(mine["unet_batch_stats"], ref_state.unet_batch_stats, 1e-5, "batch_stats")
    assert_trees_close(mine["unet_params"], ref_state.unet_params, 2.1 * LR, "params")
    for (path, p), w in zip(jax.tree_util.tree_leaves_with_path(mine["unet_params"]),
                            jax.tree.leaves(ref_state.unet_params)):
        if "kernel" in jax.tree_util.keystr(path):
            assert np.mean(np.abs(p - np.asarray(w)) > 1e-7) < 0.01, jax.tree_util.keystr(path)
    for before, p in zip(enc_before, pipe.encoder.parameters()):
        assert torch.equal(before, p) and p.grad is None  # frozen, bit-identical


def test_train_step_switches_agree(jax_params):
    """remat recomputes the transformer layers in the backward pass,
    fused_conv and fused_ln_gelu change only which wrapper the frontend
    calls, and target_gelu="tanh" only moves the target: in f32 the first
    three leave the step's loss and gradients where they were (1e-6 / 1e-5
    of the gradients' scale); the last moves the loss by less than 5%."""
    wav = np.random.default_rng(5).standard_normal((2, 8000)).astype(np.float32) * 0.1

    def run(embedder=None, **train):
        cfg = tiny(**train)
        cfg = cfg.replace(embedder=dataclasses.replace(cfg.embedder, **(embedder or {})))
        pipe = ADDvisorPipeline(cfg, device="cpu", seed=4)
        load_jax_params(pipe, jax_params)
        _, aux = make_train_step(pipe)(init_train_state(pipe), wav)
        return float(aux["loss"]), torch.cat([p.grad.flatten() for p in pipe.unet.parameters()])

    loss, grads = run()
    for embedder in (dict(remat=True), dict(fused_conv=True, fused_ln_gelu=True)):
        loss2, grads2 = run(embedder)
        assert abs(loss2 - loss) < 1e-6, embedder
        torch.testing.assert_close(grads2, grads, atol=1e-5 * float(grads.abs().max()), rtol=0)
    loss_tanh, _ = run(target_gelu="tanh")
    assert loss_tanh != loss and abs(loss_tanh - loss) < 0.05 * loss


def test_target_encoder_shares_weights():
    pipe = ADDvisorPipeline(tiny(), device="cpu")
    view = pipe.encoder.with_config(gelu="tanh", quant="none")
    assert all(a is b for a, b in zip(view.parameters(), pipe.encoder.parameters()))
    assert view.cfg.gelu == "tanh" and pipe.encoder.cfg.gelu == "exact"
    assert view.layers[0].cfg.gelu == "tanh" and pipe.encoder.layers[0].cfg.gelu == "exact"
    wav = torch.randn(1, 8000, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert not torch.equal(view(wav), pipe.encoder(wav))


# ---------------------------------------------------------------------------
# the loop, the NaN probe, checkpoints, the prefetcher
# ---------------------------------------------------------------------------


@pytest.fixture
def wav():
    return np.random.default_rng(7).standard_normal((4, 8000)).astype(np.float32) * 0.1


def test_overfit_loss_decreases(wav):
    """Loss goes down over 20 steps on one repeated tiny batch; the loss
    weights stay renormalised to sum 3."""
    pipe = ADDvisorPipeline(tiny(), device="cpu", seed=1)
    state, step = init_train_state(pipe), make_train_step(pipe)
    losses = []
    for _ in range(20):
        _, aux = step(state, wav)
        losses.append(float(aux["loss"]))
        np.testing.assert_allclose(float(aux["w"].sum()), 3.0, atol=1e-4)
    assert state.step == 20
    assert losses[-1] < losses[1] < losses[0], losses


def test_train_step_takes_deterministic_cudnn(wav, monkeypatch):
    """The step's forward and backward run with cuDNN's deterministic
    algorithms (on the card two identical steps then agree bit for bit,
    which chip_smoke.py checks), and the caller's setting is back after
    it, also when the step raises; two identical steps from the same seed
    agree bit for bit here too."""
    runs = []
    for _ in range(2):
        pipe = ADDvisorPipeline(tiny(), device="cpu", seed=1)
        seen, embed = [], pipe.embed

        def spy(w, *args, embed=embed, seen=seen, **kw):
            seen.append(torch.backends.cudnn.deterministic)
            return embed(w, *args, **kw)

        monkeypatch.setattr(pipe, "embed", spy)
        state, step = init_train_state(pipe), make_train_step(pipe)
        before = torch.backends.cudnn.deterministic
        _, aux = step(state, wav)
        assert torch.backends.cudnn.deterministic == before
        assert seen and set(seen) == {True}, seen
        runs.append((aux["loss_vec"], [p.grad.clone() for p in pipe.unet.parameters()]))
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=0, atol=0)
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="Padding size"):
        step(state, wav[:, :100])  # shorter than the STFT's reflect pad
    assert torch.backends.cudnn.deterministic == before


def test_train_loop_logs_ramps_l1_and_checkpoints(wav, tmp_path):
    pipe = ADDvisorPipeline(tiny(checkpoint_every=2), device="cpu", seed=1)
    records, saved = [], []
    state = train_addvisor(
        pipe, batches=lambda: [wav[:2], wav[2:]], num_epochs=4, log_fn=records.append,
        checkpoint_fn=lambda epoch, st, loss: saved.append(
            checkpoints.save_checkpoint(str(tmp_path), epoch, loss, st)),
        l1_scale=4.0, l1_warmup_epochs=4)
    assert state.step == 8 and state.decoder is pipe.unet
    assert [r["epoch"] for r in records] == [1, 2, 3, 4]
    assert {"epoch", "loss", "l_in", "l_out", "l1", "w", "sec"} <= set(records[0])
    # the L1 term's scale ramps 1.75, 2.5, 3.25, 4 while the mask barely moves
    ratios = [records[i]["l1"] / records[0]["l1"] for i in range(4)]
    np.testing.assert_allclose(ratios, [1.0, 2.5 / 1.75, 3.25 / 1.75, 4 / 1.75], rtol=0.02)
    assert [checkpoints.parse_checkpoint_name(p)[0] for p in saved] == [2, 4]
    assert checkpoints.latest_checkpoint(str(tmp_path)) == saved[-1]
    assert checkpoints.latest_checkpoint(str(tmp_path / "none")) is None
    # an epoch with no batch still gets its record
    records.clear()
    train_addvisor(pipe, batches=lambda: [], num_epochs=1, log_fn=records.append)
    assert records[0]["epoch"] == 1 and records[0]["loss"] == 0.0


@pytest.mark.parametrize("nan_check_every", [1, 0])
def test_nan_guard_names_the_step(wav, nan_check_every):
    """The mid-epoch probe (every step) and the epoch-end fold (probes off)
    both halt the run and name the failing step."""
    bad = wav[:2].copy()
    bad[0, 0] = np.nan
    pipe = ADDvisorPipeline(tiny(nan_check_every=nan_check_every), device="cpu", seed=1)
    with pytest.raises(FloatingPointError, match="epoch 1 step 1"):
        train_addvisor(pipe, batches=lambda: [wav[:2], bad, wav[2:]], num_epochs=1)


def test_checkpoint_round_trip_resumes_bit_for_bit(wav, tmp_path):
    """Save after one step, take a second; restore into a fresh pipeline and
    take the same second step: decoder, running statistics, w_raw and both
    optimisers' moments are bit-identical."""
    pipe = ADDvisorPipeline(tiny(), device="cpu", seed=1)
    state, step = init_train_state(pipe), make_train_step(pipe)
    step(state, wav[:2])
    path = checkpoints.save_checkpoint(str(tmp_path), epoch=1, loss=0.1234, state=state)
    assert checkpoints.parse_checkpoint_name(path) == (1, 0.1234)
    step(state, wav[2:])

    other = ADDvisorPipeline(tiny(), device="cpu", seed=99)
    other.encoder.load_state_dict(pipe.encoder.state_dict())
    other.logreg = pipe.logreg
    resumed = checkpoints.restore_checkpoint(path, init_train_state(other))
    assert resumed.step == 1
    resumed = train_addvisor(other, batches=lambda: [wav[2:]], num_epochs=1, initial_state=resumed)
    assert resumed.step == 2

    def flat(sd):
        out = {}
        for k, v in sd.items():
            if isinstance(v, dict):
                out.update({f"{k}.{k2}": v2 for k2, v2 in flat(v).items()})
            else:
                out[k] = v
        return out

    a, b = flat(state.state_dict()), flat(resumed.state_dict())
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], torch.Tensor):
            assert torch.equal(a[key], b[key]), key
        else:
            assert a[key] == b[key], key

    served = ADDvisorPipeline(tiny(), device="cpu", seed=5)
    restore_decoder_for_inference(path, served)
    bare = tmp_path / "bare.pt"
    torch.save({"module." + k: v for k, v in served.unet.state_dict().items()}, bare)
    again = ADDvisorPipeline(tiny(), device="cpu", seed=6)
    restore_decoder_for_inference(str(bare), again)
    for k, v in served.unet.state_dict().items():
        assert torch.equal(v, again.unet.state_dict()[k]), k


def test_make_optimizers_are_adam_at_the_configured_rates():
    w = torch.zeros(3, requires_grad=True)
    opt_m, opt_w = make_optimizers(tc.PipelineConfig(), [torch.nn.Parameter(torch.zeros(2))], w)
    for opt, lr in ((opt_m, 3e-5), (opt_w, 1e-4)):
        assert isinstance(opt, torch.optim.Adam)
        group = opt.param_groups[0]
        assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
            lr, (0.9, 0.999), 1e-8, 0)


def test_prefetch_runs_ahead_and_forwards_errors():
    started = threading.Event()

    def gen():
        for i in range(5):
            started.set()
            yield np.full((2, 3), i, np.float32)

    it = prefetch_to_device(gen(), torch.device("cpu"), size=2)
    first = next(it)
    assert started.wait(timeout=10) and first.dtype == torch.float32 and first.is_contiguous()
    assert [int(t[0, 0]) for t in it] == [1, 2, 3, 4]

    def failing():
        yield 1
        raise KeyError("boom")

    it = prefetch(failing())
    assert next(it) == 1
    with pytest.raises(KeyError, match="boom"):
        next(it)
