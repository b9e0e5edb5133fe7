"""PyTorch port, kernel E's module: `conv_ln_gelu_plain` against the JAX
package's Pallas kernel (interpret mode) and its reference formulation, and
the embedder with `fused_conv=True` against the JAX encoder, on the CPU.

The JAX functions take [B, L, C] and a [k, Cin, Cout] kernel, the port
[B, C, L] and torch's [Cout, Cin, k]; the tests transpose."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_audio_deepfakes_tpu.config import EmbedderConfig as JEmbedderConfig
from xai_audio_deepfakes_tpu.models.wav2vec2 import Wav2Vec2Encoder as JEncoder
from xai_audio_deepfakes_tpu.ops import pallas_conv
from tests.test_torch_models import random_params
from xai_audio_deepfakes_tpu_torch.config import EmbedderConfig
from xai_audio_deepfakes_tpu_torch.convert import load_encoder
from xai_audio_deepfakes_tpu_torch.models.wav2vec2 import Wav2Vec2Encoder
from xai_audio_deepfakes_tpu_torch.ops import _cuda
from xai_audio_deepfakes_tpu_torch.ops.cuda_conv import (
    conv_ln_gelu,
    conv_ln_gelu_plain,
    supports_fused_conv,
)


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


def conv_args(rng, k, length, batch=2, cin=128, cout=128):
    """x [B, L, Cin], kernel [k, Cin, Cout], conv bias, LN scale, LN bias, in
    the JAX layout, as tests/test_pallas.py draws them."""
    x = rng.standard_normal((batch, length, cin)).astype(np.float32)
    kern = rng.standard_normal((k, cin, cout)).astype(np.float32) * 0.05
    bias = rng.standard_normal((cout,)).astype(np.float32) * 0.1
    g = 1.0 + rng.standard_normal((cout,)).astype(np.float32) * 0.1
    lb = rng.standard_normal((cout,)).astype(np.float32) * 0.1
    return x, kern, bias, g, lb


def to_port(x, kern, *rest):
    """The JAX-layout arguments as the port's tensors."""
    return (torch.from_numpy(x.transpose(0, 2, 1).copy()),
            torch.from_numpy(kern.transpose(2, 1, 0).copy()),
            *(torch.from_numpy(a) for a in rest))


@pytest.mark.parametrize("gelu", ["exact", "tanh"])
@pytest.mark.parametrize("k,length", [(3, 515), (3, 512), (2, 500), (2, 77)])
def test_conv_ln_gelu_plain_matches_pallas_and_reference(rng, k, length, gelu):
    """f32, Cin = Cout = 128, odd and even L: atol 2e-5 against the Pallas
    kernel in interpret mode (block_t=64, so several tiles and a ragged edge)
    and against `conv_ln_gelu_reference`."""
    args = conv_args(rng, k, length)
    kw = dict(stride=2, eps=1e-5, gelu=gelu, dtype=jnp.float32)
    jargs = tuple(map(jnp.asarray, args))
    pallas = pallas_conv._conv_ln_gelu_pallas(*jargs, interpret=True, block_t=64, **kw)
    ref = pallas_conv.conv_ln_gelu_reference(*jargs, **kw)
    out = conv_ln_gelu_plain(*to_port(*args), 1e-5, gelu).numpy().transpose(0, 2, 1)
    assert out.shape == ref.shape == (2, (length - k) // 2 + 1, 128)
    np.testing.assert_allclose(out, np.asarray(pallas), atol=2e-5)
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5)


def test_conv_ln_gelu_wrapper_on_cpu_is_the_plain_version(rng):
    """A CPU tensor takes the plain version and counts no launch; a missing
    conv bias is a zero bias."""
    x, w, b, g, lb = to_port(*conv_args(rng, 3, 65))
    before = dict(_cuda.LAUNCHES)
    torch.testing.assert_close(conv_ln_gelu(x, w, b, g, lb, 1e-5, "exact"),
                               conv_ln_gelu_plain(x, w, b, g, lb, 1e-5, "exact"), atol=0, rtol=0)
    torch.testing.assert_close(conv_ln_gelu(x, w, None, g, lb, 1e-5, "exact"),
                               conv_ln_gelu_plain(x, w, torch.zeros(128), g, lb, 1e-5, "exact"),
                               atol=0, rtol=0)
    assert _cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="gelu"):
        conv_ln_gelu(x, w, b, g, lb, 1e-5, "relu")


def test_conv_ln_gelu_bf16_keeps_the_kernel_cast_points(rng):
    """bf16: the conv sum is rounded to bf16 BEFORE the f32 bias is added,
    and GELU is taken in f32 from the rounded normalised value."""
    x, w, b, g, lb = to_port(*conv_args(rng, 3, 65))
    xb, wb = x.bfloat16(), w.bfloat16()
    out = conv_ln_gelu_plain(xb, wb, b, g, lb, 1e-5, "exact")
    assert out.dtype == torch.bfloat16
    conv = torch.nn.functional.conv1d(xb.float(), wb.float(), stride=2).bfloat16().float()
    a = conv + b[:, None]
    mu = a.mean(1, keepdim=True)
    var = ((a - mu) ** 2).mean(1, keepdim=True)
    normed = ((a - mu) * torch.rsqrt(var + 1e-5) * g[:, None] + lb[:, None]).bfloat16().float()
    want = torch.nn.functional.gelu(normed).bfloat16()
    torch.testing.assert_close(out, want, atol=0, rtol=0)


@pytest.mark.parametrize("k,stride,cin,cout", [(3, 2, 512, 512), (2, 2, 128, 256), (10, 5, 1, 512),
                                               (3, 2, 8, 8), (3, 1, 128, 128), (4, 2, 128, 128)])
def test_supports_fused_conv_matches_jax(k, stride, cin, cout):
    assert supports_fused_conv(k, stride, cin, cout) == pallas_conv.supports_fused_conv(
        k, stride, cin, cout)


@pytest.fixture(scope="module")
def wide_encoder_params():
    """Random weights for the tiny embedder with conv widths of 128, so that
    layers 1 and 2 (k 3 and k 2, stride 2) are ones kernel E covers."""
    cfg = dataclasses.replace(JEmbedderConfig.tiny(), conv_dim=(128, 128, 128))
    wav = jnp.zeros((1, 8000), jnp.float32)
    return random_params(JEncoder(cfg).init, jax.random.PRNGKey(1), wav, seed=12)


@pytest.mark.parametrize("fused_ln_gelu", [False, True])
def test_encoder_fused_conv_matches_jax(rng, wide_encoder_params, fused_ln_gelu):
    """Embedder with fused_conv=True (and the Pallas kernels in interpret mode
    on the JAX side) through the bridge: features atol 5e-4; the port's
    fused and unfused f32 paths agree to 1e-5."""
    switches = dict(conv_dim=(128, 128, 128), fused_conv=True, fused_interpret=True,
                    fused_ln_gelu=fused_ln_gelu)
    wav = rng.standard_normal((2, 8000)).astype(np.float32)
    ref = np.asarray(jax.jit(JEncoder(dataclasses.replace(JEmbedderConfig.tiny(), **switches)).apply)(
        wide_encoder_params, wav))
    cfg = dataclasses.replace(EmbedderConfig.tiny(), **switches)
    enc = Wav2Vec2Encoder(cfg, torch.Generator().manual_seed(0), "cpu").eval()
    assert [b.fusable for b in enc.feature_encoder.conv_layers] == [False, True, True]
    load_encoder(enc, wide_encoder_params["params"])
    unfused = Wav2Vec2Encoder(dataclasses.replace(cfg, fused_conv=False),
                              torch.Generator().manual_seed(0), "cpu").eval()
    unfused.load_state_dict(enc.state_dict())
    with torch.no_grad():
        out, out_unfused = enc(torch.from_numpy(wav)), unfused(torch.from_numpy(wav))
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-4)
    torch.testing.assert_close(out, out_unfused, atol=1e-5, rtol=0)
