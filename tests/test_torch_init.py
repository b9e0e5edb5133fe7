"""The port's random initialiser (`models/init.py::lecun_normal_`) against
`jax.nn.initializers.lecun_normal`, and `models/unet.py::BatchNorm2d` in
training mode against flax's `nn.BatchNorm`.

The draw is held through the modules that make it (a Dense of the
embedder, the conv of a frontend block, a UNet Conv2d and ConvTranspose2d)
against JAX's on the same shape under flax's fan-in convention: the same
std (2%), max |w| at most 2 std (std = fan_in^-1/2 / 0.87962566, the
truncation), and the fraction beyond 2 fan_in^-1/2 within 0.5 points."""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_audio_deepfakes_tpu_torch import config as tc
from xai_audio_deepfakes_tpu_torch.models.init import TRUNCATED_STD
from xai_audio_deepfakes_tpu_torch.models.unet import BatchNorm2d, UNetMaskDecoder, init_unet_
from xai_audio_deepfakes_tpu_torch.models.wav2vec2 import ConvLayerNormBlock, Dense


def _stats(w: np.ndarray, fan_in: int) -> tuple[float, float, float]:
    sigma = fan_in**-0.5
    return float(w.std()), float(np.abs(w).max()), float(np.mean(np.abs(w) > 2 * sigma))


def _port_weights() -> dict:
    """name -> (the port's weight, its flax kernel shape, fan_in)."""
    g = torch.Generator().manual_seed(0)
    dense = Dense(384, 512, torch.float32, g, "cpu")
    emb = dataclasses.replace(tc.EmbedderConfig.tiny(), conv_dim=(128, 128))
    block = ConvLayerNormBlock(128, 256, 3, 2, emb, g, "cpu")
    unet = init_unet_(UNetMaskDecoder(tc.UNetConfig()), g)
    conv2d, convt = unet.d4.block[0], unet.up4
    return {
        "Dense": (dense.weight, (384, 512), 384),
        "Conv1d": (block.conv.weight, (3, 128, 256), 3 * 128),
        "Conv2d": (conv2d.weight, (3, 3) + tuple(conv2d.weight.shape[1::-1]),
                   9 * conv2d.weight.shape[1]),
        # torch [in, out, kh, kw]; flax's kernel [kh, kw, in, out]
        "ConvTranspose2d": (convt.weight, (2, 2) + tuple(convt.weight.shape[:2]),
                            4 * convt.weight.shape[0]),
    }


@pytest.mark.parametrize("kind", ["Dense", "Conv1d", "Conv2d", "ConvTranspose2d"])
def test_draw_matches_lecun_normal(kind):
    weight, flax_shape, fan_in = _port_weights()[kind]
    mine = weight.detach().float().numpy()
    assert mine.size == int(np.prod(flax_shape))
    theirs = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(1), flax_shape))
    (s_m, max_m, tail_m), (s_j, max_j, tail_j) = _stats(mine, fan_in), _stats(theirs, fan_in)
    bound = 2 * fan_in**-0.5 / TRUNCATED_STD
    assert abs(s_m - s_j) <= 0.02 * s_j and abs(s_m - fan_in**-0.5) <= 0.02 * fan_in**-0.5
    assert max_m <= bound * (1 + 1e-6) and max_j <= bound * (1 + 1e-6)
    assert abs(tail_m - tail_j) <= 0.005, (tail_m, tail_j)


def _flax_bn(x_nchw, scale, bias):
    bn = nn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-5, dtype=jnp.float32)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(scale.shape), "var": jnp.ones(scale.shape)}}
    x = jnp.asarray(x_nchw.transpose(0, 2, 3, 1))
    y, upd = bn.apply(variables, x, mutable=["batch_stats"])

    def loss(params, x):
        return jnp.sum(bn.apply({**variables, "params": params}, x, mutable=["batch_stats"])[0] ** 3)

    gp, gx = jax.grad(loss, argnums=(0, 1))(variables["params"], x)
    return (np.asarray(y).transpose(0, 3, 1, 2), upd["batch_stats"], gp,
            np.asarray(gx).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("offset", [0.0, 3.0])
def test_batch_norm_training_mode_matches_flax(offset):
    """Outputs, running statistics (flax's momentum, the biased variance)
    at f32 tolerance (1e-5, relative where flax's own f32 statistics lose
    digits) and the gradients of sum(y^3) at rtol 1e-4; with a channel mean of 3 std
    too, where E[x^2] - E[x]^2 cancels."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 6, 9, 7)) + offset).astype(np.float32)
    scale, bias = rng.standard_normal(6).astype(np.float32), rng.standard_normal(6).astype(np.float32)
    y, stats, gp, gx = _flax_bn(x, scale, bias)
    bn = BatchNorm2d(6, eps=1e-5, momentum=0.01).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = bn(xt)
    (got ** 3).sum().backward()
    # rtol: flax's f32 E[x^2] - E[x]^2 is itself off by ~1e-5 relative at offset 3
    np.testing.assert_allclose(got.detach().numpy(), y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), atol=1e-6)
    # gradients at the JAX package's gradient rtol (tests/test_pipeline_parallel.py)
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=1e-4, atol=1e-5 * float(np.abs(gx).max()))
    for t, want in ((bn.weight.grad, gp["scale"]), (bn.bias.grad, gp["bias"])):
        np.testing.assert_allclose(t.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5 * float(np.abs(np.asarray(want)).max()))
    assert int(bn.num_batches_tracked) == 1
    bn.eval()  # eval mode: the running statistics
    ref = (x - bn.running_mean.numpy()[:, None, None]) / np.sqrt(
        bn.running_var.numpy()[:, None, None] + 1e-5) * scale[:, None, None] + bias[:, None, None]
    np.testing.assert_allclose(bn(torch.from_numpy(x)).detach().numpy(), ref, atol=1e-5)
