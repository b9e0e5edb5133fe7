"""PyTorch port, on the card: each hand-written CUDA kernel against its plain
PyTorch version at the main path's shapes. Marked `gpu`; without a card the
tests skip. Run them there with

    pytest -m gpu tests/test_torch_kernels.py

This file imports nothing of JAX, so it runs where only PyTorch is
installed.
"""

import numpy as np
import pytest
import torch

from xai_audio_deepfakes_tpu_torch.config import STFTConfig
from xai_audio_deepfakes_tpu_torch.ops import stft
from xai_audio_deepfakes_tpu_torch.ops.attention import attention, attention_plain, head_pad_dim
from xai_audio_deepfakes_tpu_torch.ops.cuda_ln_gelu import ln_gelu_, ln_gelu_plain
from xai_audio_deepfakes_tpu_torch.ops.cuda_stft import istft as t_istft
from xai_audio_deepfakes_tpu_torch.ops.cuda_stft import stft as t_stft

CFG = STFTConfig()


def _padded_qkv(rng, b, t, nh, hd):
    """Head-padded [B, T, NH*128] activations with exact-zero pad lanes."""
    out = []
    for _ in range(3):
        xp = np.zeros((b, t, nh, head_pad_dim(hd)), np.float32)
        xp[..., :hd] = rng.standard_normal((b, t, nh, hd)) * 0.2
        out.append(xp.reshape(b, t, -1))
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 0.0), (torch.bfloat16, 1e-2, 1e-2)])
def test_attention_kernel_matches_plain(rng, cuda, dtype, atol, rtol):
    b, t, nh, hd = 3, 249, 4, 120
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in _padded_qkv(rng, b, t, nh, hd))
    out = attention(q, k, v, nh)
    torch.testing.assert_close(out.float(), attention_plain(q, k, v, nh).float(), atol=atol, rtol=rtol)
    assert not out.reshape(b, t, nh, -1)[..., hd:].any()


@pytest.mark.gpu
def test_stft_kernels_match_plain(rng, cuda):
    x = torch.from_numpy(rng.standard_normal((3, 80000)).astype(np.float32) * 0.3).to(cuda)
    re, im = t_stft(x, CFG)
    re_p, im_p = stft.stft_plain(x, CFG)
    torch.testing.assert_close(re, re_p, atol=2e-4, rtol=0)
    torch.testing.assert_close(im, im_p, atol=2e-4, rtol=0)
    mask = torch.from_numpy(rng.uniform(size=re.shape).astype(np.float32)).to(cuda)
    for length in (80000, 79000, 81000):
        y = t_istft(re_p * mask, im_p * mask, CFG, length)
        torch.testing.assert_close(
            y, stft.istft_plain(re_p * mask, im_p * mask, CFG, length), atol=2e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 0.0), (torch.bfloat16, 1e-2, 1e-2)])
@pytest.mark.parametrize("kind", ["exact", "tanh"])
def test_ln_gelu_kernel_matches_plain(rng, cuda, dtype, atol, rtol, kind):
    x = torch.from_numpy(rng.standard_normal((3, 512, 999)).astype(np.float32) * 2 + 0.5)
    x = x.to(cuda, dtype)
    g = torch.from_numpy((1 + 0.1 * rng.standard_normal(512)).astype(np.float32)).to(cuda)
    lb = torch.from_numpy((0.1 * rng.standard_normal(512)).astype(np.float32)).to(cuda)
    want = ln_gelu_plain(x, g, lb, 1e-5, kind)
    got = ln_gelu_(x.clone(), g, lb, 1e-5, kind)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
