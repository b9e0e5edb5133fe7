"""PyTorch port, the feature decoder: `FeatureMaskDecoder` against flax (f32
and eager bf16), its weight bridge, `explain(decoder="features")` and one
LMAC training step of the feature decoder against the JAX package, on the
CPU. The explain and the step need the frame alignment of the real
geometry (80000-sample clips, the default conv kernels and strides: 249
embedder frames = 249 STFT frames), at narrow widths."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_audio_deepfakes_tpu import config as jc
from xai_audio_deepfakes_tpu.losses import lmac as j_lmac
from xai_audio_deepfakes_tpu.models.feat_decoder import FeatureMaskDecoder as JDecoder
from xai_audio_deepfakes_tpu.models.logreg import LogReg
from xai_audio_deepfakes_tpu.models.logreg import logreg_apply as j_logreg_apply
from xai_audio_deepfakes_tpu.ops.normalize import zero_mean_unit_var_norm as j_norm
from xai_audio_deepfakes_tpu.pipeline.core import ADDvisorPipeline as JPipeline
from tests.test_torch_bf16 import _assert_bars
from tests.test_torch_models import TINY_UNET, random_params
from tests.test_torch_train import LR, assert_trees_close
from xai_audio_deepfakes_tpu_torch import config as tc
from xai_audio_deepfakes_tpu_torch.convert import (
    feat_decoder_variables_to_jax,
    load_feat_decoder,
    load_jax_params,
    train_state_to_jax,
)
from xai_audio_deepfakes_tpu_torch.models.feat_decoder import FeatureMaskDecoder
from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline
from xai_audio_deepfakes_tpu_torch.train import checkpoints
from xai_audio_deepfakes_tpu_torch.train.train_addvisor import (
    decoder_params_key,
    init_train_state,
    make_train_step,
    restore_decoder_for_inference,
)

j_train = importlib.import_module("xai_audio_deepfakes_tpu.train.train_addvisor")
SMALL = dict(feature_dim=32, hidden=16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Backward passes on several xdist workers: one intra-op thread each
    (see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def aligned(mod, **feat_decoder):
    """80000-sample clips through the default conv kernels and strides (249
    frames, as the STFT's) at narrow widths, in either package's config."""
    return mod.PipelineConfig(
        embedder=mod.EmbedderConfig(hidden_size=32, num_layers=2, num_heads=2,
                                    intermediate_size=64, conv_dim=(8,) * 7,
                                    num_conv_pos_embeddings=16,
                                    num_conv_pos_embedding_groups=2, output_layer=2),
        unet=mod.UNetConfig(**TINY_UNET),
        feat_decoder=mod.FeatDecoderConfig(**SMALL, **feat_decoder))


def _decoder_params(cfg, seed: int, frames: int = 249) -> dict:
    return random_params(JDecoder(cfg).init, jax.random.PRNGKey(0),
                         jnp.zeros((1, frames, cfg.feature_dim)), seed=seed)


@pytest.fixture(scope="module")
def jax_params():
    """Random numpy weights for the aligned pipeline in the JAX tree, the
    feature decoder included."""
    cfg = aligned(jc)
    jpipe = JPipeline(cfg)
    wav = jnp.zeros((1, cfg.audio.num_samples), jnp.float32)
    mag = jnp.zeros((1, cfg.unet.freq_bins, cfg.unet.frames), jnp.float32)
    return {
        "encoder": random_params(jpipe.encoder.init, jax.random.PRNGKey(0), wav, seed=1),
        "unet": random_params(jpipe.unet.init, jax.random.PRNGKey(0), mag, seed=2),
        "feat_decoder": _decoder_params(cfg.feat_decoder, seed=3),
        "logreg": jax.tree.map(np.asarray, LogReg.init(cfg.embedder.hidden_size, seed=4)),
    }


@pytest.fixture(scope="module")
def wav():
    return np.random.default_rng(5).standard_normal((2, 80000)).astype(np.float32) * 0.1


def test_feat_decoder_config_matches_jax():
    mine, ref = tc.FeatDecoderConfig(), jc.FeatDecoderConfig()
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert tc.PipelineConfig().feat_decoder == mine


def _port_decoder(cfg, params) -> FeatureMaskDecoder:
    model = FeatureMaskDecoder(cfg, torch.Generator().manual_seed(0), "cpu").eval()
    load_feat_decoder(model, params)
    return model


@pytest.mark.parametrize("attn_layers", [0, 2])
def test_feat_decoder_matches_flax(attn_layers):
    """f32: the mask [B, 512, T] agrees with flax's within 1e-5; with
    attention blocks (8 heads of 2) too. The bridge inverts exactly."""
    cfg_j = jc.FeatDecoderConfig(**SMALL, attn_layers=attn_layers)
    params = _decoder_params(cfg_j, seed=6, frames=40)
    feats = np.random.default_rng(7).standard_normal((2, 40, 32)).astype(np.float32)
    want = np.asarray(jax.jit(JDecoder(cfg_j).apply)(params, feats))
    model = _port_decoder(tc.FeatDecoderConfig(**SMALL, attn_layers=attn_layers), params)
    with torch.no_grad():
        got = model(torch.from_numpy(feats))
    assert got.shape == (2, 512, 40) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert_trees_close(feat_decoder_variables_to_jax(model), params, 0, "params")


@pytest.mark.parametrize("attn_layers", [0, 1])
def test_bf16_feat_decoder_matches_eager_jax(attn_layers):
    """bf16 (tanh GELU rounded per operation, LayerNorms in f32 with eps
    1e-6, the bias after the rounded product, the softmax in bf16) against
    eager flax in bf16, at the bars of tests/test_torch_bf16.py: the mean
    deviation at most 0.4x JAX's own bf16-vs-f32 one, the max at most that
    deviation's max or two bf16 steps."""
    params = _decoder_params(jc.FeatDecoderConfig(**SMALL, attn_layers=attn_layers), seed=8,
                             frames=40)
    feats = np.random.default_rng(9).standard_normal((2, 40, 32)).astype(np.float32)
    ref = {dt: np.asarray(JDecoder(jc.FeatDecoderConfig(**SMALL, attn_layers=attn_layers,
                                                        dtype=dt)).apply(params, feats))
           for dt in ("bfloat16", "float32")}
    model = _port_decoder(tc.FeatDecoderConfig(**SMALL, attn_layers=attn_layers,
                                               dtype="bfloat16"), params)
    with torch.no_grad():
        got = model(torch.from_numpy(feats)).numpy()
    _assert_bars(got, ref["bfloat16"], ref["float32"], "bf16 feature-decoder mask")


def test_features_explain_matches_jax(jax_params, wav):
    """`explain(decoder="features")` against the JAX pipeline's jit_explain
    on the same weights: mask 1e-5, waveforms 2e-4, probabilities 1e-4;
    `predict_mask_from_features` pads the [B, 512, 249] mask to the
    spectrogram's 513 bins."""
    ref = JPipeline(aligned(jc)).jit_explain(decoder="features")(jax_params, jnp.asarray(wav))
    pipe = ADDvisorPipeline(aligned(tc), device="cpu", seed=9)
    load_jax_params(pipe, jax_params)
    out = pipe.explain(wav, decoder="features")
    assert out.mask.shape == (2, 513, 249) and bool((out.mask[:, 512] == 0).all())
    for name, atol in (("mask", 1e-5), ("magnitude", 1e-4), ("relevant_wav", 2e-4),
                       ("irrelevant_wav", 2e-4), ("probs_clean", 1e-4),
                       ("probs_relevant", 1e-4), ("probs_irrelevant", 1e-4)):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=atol, err_msg=name)


def test_misaligned_config_raises():
    """The tiny embedder of tests/test_pipeline.py downsamples 20x: 399
    feature frames against 25 STFT frames. The mask does not fit the
    spectrogram and the explain raises, as JAX's does."""
    cfg = tc.PipelineConfig(audio=tc.AudioConfig(clip_seconds=0.5),
                            embedder=tc.EmbedderConfig.tiny(), unet=tc.UNetConfig(**TINY_UNET),
                            feat_decoder=tc.FeatDecoderConfig(**SMALL))
    pipe = ADDvisorPipeline(cfg, device="cpu")
    with pytest.raises(ValueError, match="do not align"):
        pipe.explain(np.zeros((1, 8000), np.float32) + 0.01, decoder="features")


def _jax_features_step(params, wav):
    """The JAX package's jitted feature-decoder step, and the gradients of
    its loss rebuilt from the same public functions the step calls."""
    cfg = aligned(jc)
    jpipe = JPipeline(cfg)
    tx_m, tx_w = j_train.make_optimizers(cfg)
    state = j_train.init_train_state(jpipe, params, tx_m, tx_w, decoder="features")
    frozen = {"encoder": params["encoder"], "logreg": params["logreg"]}
    step = j_train.make_train_step(jpipe, tx_m, tx_w, decoder="features")
    new_state, aux = jax.jit(step)(state, frozen, wav)

    def classify(x):
        feats = jpipe.encoder.apply(params["encoder"], j_norm(x))
        return j_logreg_apply(params["logreg"], jnp.mean(feats, axis=1))[0]

    def loss_fn(dec_params, w_raw):
        _, _, mag, phase = jpipe.spectrogram(wav)
        feats = jax.lax.stop_gradient(jpipe.encoder.apply(params["encoder"], j_norm(wav)))
        class_pred = jax.nn.sigmoid(j_logreg_apply(params["logreg"], jnp.mean(feats, axis=1))[0])
        mask = jpipe.feat_decoder.apply({"params": dec_params}, feats)
        return j_lmac.lmac_loss(w_raw, mask, mag, phase, class_pred, classify, jpipe.istft,
                                cfg.loss)[0]

    grads = jax.jit(jax.grad(loss_fn, argnums=(0, 1)))(params["feat_decoder"]["params"],
                                                       state.w_raw)
    return new_state, aux, grads


def test_features_train_step_matches_jax(jax_params, wav):
    """One feature-decoder training step against JAX's, at the bars of
    tests/test_torch_train.py::test_train_step_matches_jax: losses and the
    first mask 1e-5, decoder gradients rtol 1e-3 with an atol of 1e-4 of
    the largest, the w_raw gradient and update 1e-6, the updated decoder
    within 2.1 lr (1e-7 on 99% of the kernels); the embedder stays
    bit-identical and the state has no batch statistics."""
    ref_state, ref_aux, (ref_g, ref_gw) = _jax_features_step(jax_params, jnp.asarray(wav))
    pipe = ADDvisorPipeline(aligned(tc), device="cpu", seed=4)
    load_jax_params(pipe, jax_params)
    enc_before = [p.detach().clone() for p in pipe.encoder.parameters()]
    state = init_train_state(pipe, decoder="features")
    assert state.decoder is pipe.feat_decoder
    _, aux = make_train_step(pipe, decoder="features")(state, wav)

    for name in ("loss", "l_in", "l_out", "l1", "loss_vec", "mask_first"):
        np.testing.assert_allclose(aux[name].numpy(), np.asarray(ref_aux[name]), atol=1e-5,
                                   err_msg=name)
    holder = FeatureMaskDecoder(pipe.cfg.feat_decoder, torch.Generator(), "cpu")
    with torch.no_grad():
        for p, src in zip(holder.parameters(), pipe.feat_decoder.parameters()):
            p.copy_(src.grad)
    grads = feat_decoder_variables_to_jax(holder)["params"]
    scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(ref_g))
    assert jax.tree.structure(grads) == jax.tree.structure(jax.tree.map(np.asarray, ref_g))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(grads), jax.tree.leaves(ref_g)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))
    np.testing.assert_allclose(state.w_raw.grad.numpy(), np.asarray(ref_gw), atol=1e-6)

    mine = train_state_to_jax(state)
    assert mine["unet_batch_stats"] == {} and not ref_state.unet_batch_stats
    np.testing.assert_allclose(mine["w_raw"], np.asarray(ref_state.w_raw), atol=1e-6)
    np.testing.assert_allclose(aux["w"].numpy(), np.asarray(ref_aux["w"]), atol=1e-6)
    assert_trees_close(mine["unet_params"], ref_state.unet_params, 2.1 * LR, "params")
    for (path, p), w in zip(jax.tree_util.tree_leaves_with_path(mine["unet_params"]),
                            jax.tree.leaves(ref_state.unet_params)):
        if "kernel" in jax.tree_util.keystr(path):
            assert np.mean(np.abs(p - np.asarray(w)) > 1e-7) < 0.01, jax.tree_util.keystr(path)
    for before, p in zip(enc_before, pipe.encoder.parameters()):
        assert torch.equal(before, p) and p.grad is None


def test_restore_feature_decoder_for_inference(tmp_path):
    """A feature-decoder checkpoint (full train state, or a bare state dict
    with the DDP `module.` prefix) restores into another pipeline's feature
    decoder; `decoder_params_key` names the JAX tree's keys."""
    assert (decoder_params_key("unet"), decoder_params_key("features")) == ("unet", "feat_decoder")
    with pytest.raises(ValueError, match="unknown decoder"):
        decoder_params_key("nope")
    cfg = aligned(tc, attn_layers=1)
    pipe = ADDvisorPipeline(cfg, device="cpu", seed=1)
    state = init_train_state(pipe, decoder="features")
    with torch.no_grad():
        for p in pipe.feat_decoder.parameters():
            p.add_(0.01)
    path = checkpoints.save_checkpoint(str(tmp_path), 1, 0.5, state)
    bare = tmp_path / "bare.pt"
    torch.save({"module." + k: v for k, v in pipe.feat_decoder.state_dict().items()}, bare)
    for src in (path, str(bare)):
        other = ADDvisorPipeline(cfg, device="cpu", seed=2)
        model = restore_decoder_for_inference(src, other, decoder="features")
        assert model is other.feat_decoder and not model.training
        for k, v in pipe.feat_decoder.state_dict().items():
            assert torch.equal(v, model.state_dict()[k]), k
