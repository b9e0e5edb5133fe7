"""PyTorch port, models: the UNet mask decoder, the wav2vec2 embedder and the
LogReg head against the JAX package on the CPU, through the weight bridge
(`xai_audio_deepfakes_tpu_torch/convert.py`), at tiny widths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_audio_deepfakes_tpu.config import EmbedderConfig as JEmbedderConfig
from xai_audio_deepfakes_tpu.config import UNetConfig as JUNetConfig
from xai_audio_deepfakes_tpu.models.logreg import LogReg
from xai_audio_deepfakes_tpu.models.logreg import logreg_apply as j_logreg_apply
from xai_audio_deepfakes_tpu.models.unet import UNetMaskDecoder as JUNet
from xai_audio_deepfakes_tpu.models.unet import params_from_torch_state_dict
from xai_audio_deepfakes_tpu.models.wav2vec2 import Wav2Vec2Encoder as JEncoder
from xai_audio_deepfakes_tpu.ops.normalize import zero_mean_unit_var_norm as j_norm
from xai_audio_deepfakes_tpu_torch.config import EmbedderConfig, UNetConfig
from xai_audio_deepfakes_tpu_torch.convert import load_encoder, load_unet
from xai_audio_deepfakes_tpu_torch.models.logreg import logreg_apply
from xai_audio_deepfakes_tpu_torch.models.unet import (
    UNetMaskDecoder,
    init_unet_,
    load_reference_state_dict,
)
from xai_audio_deepfakes_tpu_torch.models.wav2vec2 import HeadDense, Wav2Vec2Encoder

TINY_UNET = dict(freq_bins=64, frames=24, base_channels=4)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def random_params(init, *args, seed: int = 0):
    """Random numpy weights in the tree a flax `init(*args)` would return.
    `jax.eval_shape` gives the tree without compiling the init; the values
    are drawn with numpy: kernels ~ N(0, 1/fan_in), LayerNorm and BatchNorm
    scales and BatchNorm variances around 1, means and biases near 0."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if "var" in name or "scale" in name:
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if len(shape) >= 2:
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init, *args))


@pytest.fixture(scope="module")
def jax_unet():
    return JUNet(JUNetConfig(**TINY_UNET))


def test_unet_mask_matches_jax(rng, jax_unet):
    """UNet through the bridge: mask atol 1e-5 at UNetConfig(64, 24, 4)."""
    mag = rng.uniform(0, 2, (2, 64, 24)).astype(np.float32)
    variables = random_params(jax_unet.init, jax.random.PRNGKey(0), mag)
    ref = np.asarray(jax.jit(jax_unet.apply)(variables, jnp.asarray(mag)))
    model = UNetMaskDecoder(UNetConfig(**TINY_UNET)).eval()
    load_unet(model, variables)
    with torch.no_grad():
        out = model(torch.from_numpy(mag)).numpy()
    assert out.shape == (2, 64, 24)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_unet_state_dict_round_trip_through_jax_importer(rng, jax_unet):
    """Port UNet state dict (with the DDP `module.` prefix) -> the JAX
    package's `params_from_torch_state_dict` -> the JAX mask equals the
    port's; the same dict also loads back into a fresh port UNet."""
    cfg = UNetConfig(**TINY_UNET)
    model = init_unet_(UNetMaskDecoder(cfg), torch.Generator().manual_seed(3))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.1)
    model.eval()
    sd = {"module." + k: v for k, v in model.state_dict().items()}
    mag = rng.uniform(0, 2, (2, 64, 24)).astype(np.float32)
    with torch.no_grad():
        mine = model(torch.from_numpy(mag)).numpy()
    ref = jax.jit(jax_unet.apply)(params_from_torch_state_dict(sd), jnp.asarray(mag))
    np.testing.assert_allclose(mine, np.asarray(ref), atol=1e-5)
    fresh = UNetMaskDecoder(cfg).eval()
    load_reference_state_dict(fresh, sd)
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(torch.from_numpy(mag)).numpy(), mine)


@pytest.fixture(scope="module")
def encoder_params():
    """Random weights in the tiny JAX embedder's parameter tree."""
    wav = jnp.zeros((1, 8000), jnp.float32)
    return random_params(JEncoder(JEmbedderConfig.tiny()).init, jax.random.PRNGKey(1), wav,
                         seed=11)


@pytest.mark.parametrize("gelu", ["exact", "tanh"])
def test_encoder_features_match_jax(rng, encoder_params, gelu):
    """Tiny embedder through the bridge: features atol 5e-4 (BASELINE.md's
    hidden-state bar); flax LayerNorm's E[x^2]-E[x]^2 variance vs
    F.layer_norm's centred one differs by ~1e-6 relative at f32."""
    import dataclasses

    params = encoder_params
    wav = np.array(j_norm(jnp.asarray(rng.standard_normal((2, 8000)).astype(np.float32) * 0.1)))
    enc = JEncoder(dataclasses.replace(JEmbedderConfig.tiny(), gelu=gelu))
    ref = np.asarray(jax.jit(enc.apply)(params, wav))
    cfg = dataclasses.replace(EmbedderConfig.tiny(), gelu=gelu)
    mine_enc = Wav2Vec2Encoder(cfg, torch.Generator().manual_seed(0), "cpu").eval()
    load_encoder(mine_enc, params["params"])
    with torch.no_grad():
        out = mine_enc(torch.from_numpy(wav)).numpy()
    assert out.shape == ref.shape == (2, 399, 32)
    np.testing.assert_allclose(out, ref, atol=5e-4)


@pytest.mark.parametrize("pad_axis", [0, 1])
def test_head_dense_padding_matches_dense(rng, pad_axis):
    """Padded projection == the plain Linear on the real lanes, pad lanes
    exactly 0 (q/k/v) and pad rows inert (out_proj)."""
    h, nh, hd = 32, 2, 16
    dense = HeadDense(h, nh, hd, pad_axis, torch.float32, torch.Generator().manual_seed(0), "cpu")
    w = torch.from_numpy(rng.standard_normal((h, h)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(h).astype(np.float32))
    dense.set_dense(w, b)
    x = torch.from_numpy(rng.standard_normal((2, 5, h)).astype(np.float32))
    with torch.no_grad():
        if pad_axis == 1:
            out = dense(x).reshape(2, 5, nh, 128)
            torch.testing.assert_close(out[..., :hd].reshape(2, 5, h), x @ w.T + b)
            assert not out[..., hd:].any()
        else:
            xp = torch.zeros(2, 5, nh, 128)
            xp[..., :hd] = x.reshape(2, 5, nh, hd)
            xp[..., hd:] = 7.0  # pad rows of the weight are zero
            torch.testing.assert_close(dense(xp.reshape(2, 5, -1)), x @ w.T + b)


def test_logreg_matches_jax(rng):
    params = _numpy_tree(LogReg.init(32, seed=4))
    feats = rng.standard_normal((3, 32)).astype(np.float32)
    logits, probs = logreg_apply({k: torch.from_numpy(np.array(v)) for k, v in params.items()},
                                 torch.from_numpy(feats))
    jl, jp = j_logreg_apply(params, jnp.asarray(feats))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-6)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jp), atol=1e-6)
