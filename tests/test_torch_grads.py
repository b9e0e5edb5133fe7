"""PyTorch port, gradients through the kernel wrappers: each
`torch.autograd.Function` (attention, STFT, iSTFT, LN+GELU, conv+LN+GELU)
against `jax.grad` through the JAX function with its Pallas kernel in
interpret mode, in f32 on the CPU. The loss is sum(out ** 2), as in
tests/test_pallas.py; the tolerance is 1e-4 of the gradient's largest
magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_audio_deepfakes_tpu.config import STFTConfig as JSTFTConfig
from xai_audio_deepfakes_tpu.ops import attention as j_attention
from xai_audio_deepfakes_tpu.ops import pallas_conv, pallas_ln_gelu, pallas_stft
from tests.test_torch_conv import conv_args, to_port
from tests.test_torch_kernels import _padded_qkv
from xai_audio_deepfakes_tpu_torch.config import STFTConfig
from xai_audio_deepfakes_tpu_torch.ops import attention, cuda_conv, cuda_ln_gelu, cuda_stft


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


def assert_grads_close(got, want, names):
    for g, w, name in zip(got, want, names):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(), rtol=0, err_msg=name)


def torch_grads(fn, *arrays):
    """d sum(fn(*tensors) ** 2) / d tensors, as numpy."""
    ts = [torch.from_numpy(np.array(a)).requires_grad_() for a in arrays]
    out = fn(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    sum((o ** 2).sum() for o in outs).backward()
    return [t.grad.numpy() for t in ts]


def test_attention_grad_matches_jax(rng):
    b, t, nh, hd = 1, 37, 2, 24
    q, k, v = _padded_qkv(rng, b, t, nh, hd)
    want = jax.grad(lambda q, k, v: jnp.sum(j_attention.attention(q, k, v, nh, True) ** 2),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = torch_grads(lambda q, k, v: attention.attention(q, k, v, nh), q, k, v)
    assert_grads_close(got, want, "qkv")
    # the backward is _attention_bwd's formula, not autograd through the plain version
    fn_out = attention.attention(*(torch.from_numpy(a).requires_grad_() for a in (q, k, v)), nh)
    assert type(fn_out.grad_fn).__name__ == "_AttentionBackward"


def test_stft_and_istft_grads_match_jax(rng):
    """B and C are linear: their vjps need no saved input. 8000 samples,
    25 frames."""
    n = 8000
    x = rng.standard_normal((2, n)).astype(np.float32) * 0.3
    f_stft = pallas_stft.make_fused_stft(JSTFTConfig(), interpret=True)
    f_istft = pallas_stft.make_fused_istft(JSTFTConfig(), length=n, interpret=True)
    want = jax.grad(lambda x: sum(jnp.sum(o ** 2) for o in f_stft(x)))(jnp.asarray(x))
    (got,) = torch_grads(lambda x: cuda_stft.stft(x, STFTConfig()), x)
    assert_grads_close([got], [want], ["stft"])

    re = rng.standard_normal((2, 513, 25)).astype(np.float32)
    im = rng.standard_normal((2, 513, 25)).astype(np.float32)
    want = jax.grad(lambda re, im: jnp.sum(f_istft(re, im) ** 2), argnums=(0, 1))(
        jnp.asarray(re), jnp.asarray(im))
    got = torch_grads(lambda re, im: cuda_stft.istft(re, im, STFTConfig(), n), re, im)
    assert_grads_close(got, want, ["re", "im"])


@pytest.mark.parametrize("gelu", ["exact", "tanh"])
def test_ln_gelu_grad_matches_jax(rng, gelu):
    g = 1.0 + rng.standard_normal((128,)).astype(np.float32) * 0.1
    lb = rng.standard_normal((128,)).astype(np.float32) * 0.1
    x = rng.standard_normal((1, 131, 128)).astype(np.float32)
    want = jax.grad(
        lambda x, g, lb: jnp.sum(pallas_ln_gelu.ln_gelu(x, g, lb, 1e-5, gelu, jnp.float32, True) ** 2),
        argnums=(0, 1, 2))(*map(jnp.asarray, (x, g, lb)))
    xt = x.transpose(0, 2, 1).copy()
    got = torch_grads(lambda x, g, lb: cuda_ln_gelu.ln_gelu(x, g, lb, 1e-5, gelu), xt, g, lb)
    got[0] = got[0].transpose(0, 2, 1)
    assert_grads_close(got, want, ["x", "scale", "bias"])


def test_ln_gelu_with_grad_leaves_its_input_alone(rng):
    """With a gradient recorded the launch is out of place: the input, which
    the backward recomputes from, is not overwritten. Without one the result
    lands in the input's buffer."""
    x = torch.from_numpy(rng.standard_normal((1, 16, 9)).astype(np.float32))
    g, lb = torch.ones(16), torch.zeros(16)
    leaf = x.clone().requires_grad_()
    y = leaf * 1.0
    kept = y.detach().clone()
    out = cuda_ln_gelu.ln_gelu(y, g, lb, 1e-5, "exact")
    assert out.data_ptr() != y.data_ptr()
    torch.testing.assert_close(y.detach(), kept, atol=0, rtol=0)
    out.sum().backward()  # would raise if y had been modified in place
    plain = x.clone()
    assert cuda_ln_gelu.ln_gelu(plain, g, lb, 1e-5, "exact").data_ptr() == plain.data_ptr()
    torch.testing.assert_close(plain, out.detach(), atol=0, rtol=0)


@pytest.mark.parametrize("k", [3, 2])
def test_conv_ln_gelu_grad_matches_jax(rng, k):
    args = conv_args(rng, k, 131, batch=1)
    want = jax.grad(
        lambda *a: jnp.sum(pallas_conv.conv_ln_gelu(*a, 2, 1e-5, "exact", jnp.float32, True) ** 2),
        argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    got = torch_grads(lambda *a: cuda_conv.conv_ln_gelu(*a, 1e-5, "exact"),
                      *(t.numpy() for t in to_port(*args)))
    got[0], got[1] = got[0].transpose(0, 2, 1), got[1].transpose(2, 1, 0)
    assert_grads_close(got, want, ["x", "kernel", "conv_bias", "scale", "bias"])
