"""PyTorch port, ops: DSP, masking and the kernel modules against the JAX
package on the CPU (numpy-seeded inputs fed to both sides).

On the CPU each port wrapper runs its kernel's plain version; where the JAX
function has a Pallas kernel, one case runs that kernel in interpret mode as
tests/test_pallas.py does. tests/test_torch_kernels.py holds the CUDA
kernels against these plain versions on the card.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_audio_deepfakes_tpu.config import MaskingConvention as JMasking
from xai_audio_deepfakes_tpu.config import STFTConfig as JSTFTConfig
from xai_audio_deepfakes_tpu.ops import masking as jmask
from xai_audio_deepfakes_tpu.ops.normalize import zero_mean_unit_var_norm as j_norm
from xai_audio_deepfakes_tpu.ops.pad import pad_or_crop as j_pad_or_crop
from xai_audio_deepfakes_tpu.ops.window import torch_style_window as j_window
from xai_audio_deepfakes_tpu_torch.config import MaskingConvention, STFTConfig
from xai_audio_deepfakes_tpu_torch.ops import masking, stft
from xai_audio_deepfakes_tpu_torch.ops.attention import (
    attention,
    attention_plain,
    attention_reference,
    head_pad_dim,
)
from xai_audio_deepfakes_tpu_torch.ops.cuda_ln_gelu import ln_gelu_
from xai_audio_deepfakes_tpu_torch.ops.cuda_stft import istft as t_istft
from xai_audio_deepfakes_tpu_torch.ops.cuda_stft import stft as t_stft
from xai_audio_deepfakes_tpu_torch.ops.normalize import zero_mean_unit_var_norm
from xai_audio_deepfakes_tpu_torch.ops.pad import pad_or_crop
from xai_audio_deepfakes_tpu_torch.ops.window import torch_style_window

# the module, not the function that `ops/__init__.py` re-exports under its name
jstft = importlib.import_module("xai_audio_deepfakes_tpu.ops.stft")
CFG, JCFG = STFTConfig(), JSTFTConfig()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("kind,win", [("rect", 644), ("hann", 1024)])
def test_window_and_dsp_constants_equal_jax(kind, win):
    np.testing.assert_array_equal(torch_style_window(kind, win, 1024), j_window(kind, win, 1024))
    for mine, ref in zip(stft._dft_bases(1024), jstft._dft_bases(1024)):
        np.testing.assert_array_equal(mine, ref)
    for mine, ref in zip(stft._idft_bases(1024), jstft._idft_bases(1024)):
        np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(
        stft._ola_envelope(249, 1024, 322, kind, win),
        jstft._ola_envelope(249, 1024, 322, kind, win),
    )


@pytest.mark.parametrize("length", [7000, 8000, 9000])
def test_pad_or_crop_and_normalize_match_jax(rng, length):
    x = rng.standard_normal((2, length)).astype(np.float32) * 0.3
    np.testing.assert_array_equal(
        _np(pad_or_crop(torch.from_numpy(x), 8000)), np.asarray(j_pad_or_crop(jnp.asarray(x), 8000))
    )
    # unbiased std, eps outside the sqrt; f32 sums in another order
    np.testing.assert_allclose(
        _np(zero_mean_unit_var_norm(torch.from_numpy(x))),
        np.asarray(j_norm(jnp.asarray(x))), atol=1e-5,
    )


def test_stft_matches_jax_and_pallas_interpret(rng):
    """Plain version of kernel B vs the JAX matmul-DFT STFT at 2x80000 and vs
    the Pallas kernel in interpret mode, atol 2e-4 (test_pallas.py's bar)."""
    from xai_audio_deepfakes_tpu.ops.pallas_stft import stft_pallas

    x = rng.standard_normal((2, 80000)).astype(np.float32) * 0.3
    re, im = t_stft(torch.from_numpy(x), CFG)
    assert re.shape == im.shape == (2, 513, 249)
    re_j, im_j = jstft.stft(jnp.asarray(x), JCFG)
    np.testing.assert_allclose(_np(re), np.asarray(re_j), atol=2e-4)
    np.testing.assert_allclose(_np(im), np.asarray(im_j), atol=2e-4)
    re_p, im_p = stft_pallas(jnp.asarray(x), JCFG, interpret=True)
    np.testing.assert_allclose(_np(re), np.asarray(re_p), atol=2e-4)
    np.testing.assert_allclose(_np(im), np.asarray(im_p), atol=2e-4)


def test_istft_matches_jax_and_pallas_interpret(rng):
    """Plain version of kernel C vs the JAX iSTFT and the Pallas kernel in
    interpret mode on a masked spectrum at 1x80000, atol 2e-4."""
    from xai_audio_deepfakes_tpu.ops.pallas_stft import istft_pallas

    x = rng.standard_normal((1, 80000)).astype(np.float32) * 0.3
    re_j, im_j = jstft.stft(jnp.asarray(x), JCFG)
    mask = rng.uniform(size=re_j.shape).astype(np.float32)
    re = np.asarray(re_j) * mask
    im = np.asarray(im_j) * mask
    y = _np(t_istft(torch.from_numpy(re), torch.from_numpy(im), CFG, 80000))
    assert y.shape == (1, 80000)
    np.testing.assert_allclose(y, np.asarray(jstft.istft(re, im, JCFG, length=80000)), atol=2e-4)
    y_p = istft_pallas(jnp.asarray(re), jnp.asarray(im), JCFG, length=80000, interpret=True)
    np.testing.assert_allclose(y, np.asarray(y_p), atol=2e-4)


@pytest.mark.parametrize("length", [7000, 9000])
def test_istft_crop_and_zero_pad_match_jax(rng, length):
    x = rng.standard_normal((2, 8000)).astype(np.float32) * 0.3
    re_j, im_j = jstft.stft(jnp.asarray(x), JCFG)
    re, im = np.array(re_j), np.array(im_j)
    y = _np(t_istft(torch.from_numpy(re), torch.from_numpy(im), CFG, length))
    np.testing.assert_allclose(y, np.asarray(jstft.istft(re, im, JCFG, length=length)), atol=2e-4)


@pytest.mark.parametrize("conv", ["linear", "log1p"])
def test_masking_matches_jax(rng, conv):
    mag = rng.uniform(0, 3, (2, 65, 25)).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, mag.shape).astype(np.float32)
    mask = rng.uniform(size=(2, 64, 24)).astype(np.float32)
    tm = masking.pad_mask_to_spec(torch.from_numpy(mask), 65, 25)
    jm = jmask.pad_mask_to_spec(jnp.asarray(mask), 65, 25)
    np.testing.assert_array_equal(_np(tm), np.asarray(jm))
    np.testing.assert_array_equal(
        _np(masking.crop_spec(torch.from_numpy(mag), 64, 24)),
        np.asarray(jmask.crop_spec(jnp.asarray(mag), 64, 24)),
    )
    rel, irr = masking.apply_mask(tm, torch.from_numpy(mag), MaskingConvention(conv))
    jrel, jirr = jmask.apply_mask(jm, jnp.asarray(mag), JMasking(conv))
    np.testing.assert_allclose(_np(rel), np.asarray(jrel), atol=1e-6)
    np.testing.assert_allclose(_np(irr), np.asarray(jirr), atol=1e-6)
    for a, b in zip(masking.remask_complex(rel, torch.from_numpy(phase)),
                    jmask.remask_complex(jrel, jnp.asarray(phase))):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-6)


def _padded_qkv(rng, b, t, nh, hd, hdp):
    """[B, T, NH, HD] activations and their head-padded [B, T, NH*HDP] form."""
    out = []
    for _ in range(3):
        x = rng.standard_normal((b, t, nh, hd)).astype(np.float32) * 0.2
        xp = np.zeros((b, t, nh, hdp), np.float32)
        xp[..., :hd] = x
        out.append((x, xp.reshape(b, t, nh * hdp)))
    return out


def test_attention_matches_pallas_interpret(rng):
    """Plain version of kernel A vs the Pallas kernel (interpret) at b=2,
    t=249, nh=2, hd 120 -> 128: atol 1e-5, pad lanes exactly 0."""
    from xai_audio_deepfakes_tpu.ops.attention import attention_pallas

    b, t, nh, hd = 2, 249, 2, 120
    hdp = head_pad_dim(hd)
    (_, qp), (_, kp), (_, vp) = _padded_qkv(rng, b, t, nh, hd, hdp)
    out = _np(attention(*(torch.from_numpy(a) for a in (qp, kp, vp)), nh))
    ref = np.asarray(attention_pallas(jnp.asarray(qp), jnp.asarray(kp), jnp.asarray(vp), nh,
                                      interpret=True))
    np.testing.assert_allclose(out, ref, atol=1e-5)
    np.testing.assert_array_equal(out.reshape(b, t, nh, hdp)[..., hd:], 0.0)


def test_attention_reference_matches_jax(rng):
    from xai_audio_deepfakes_tpu.ops.attention import attention_reference as j_ref

    b, t, nh, hd = 2, 37, 2, 24
    (q, qp), (k, kp), (v, vp) = _padded_qkv(rng, b, t, nh, hd, head_pad_dim(hd))
    mine = _np(attention_reference(*(torch.from_numpy(a) for a in (q, k, v))))
    np.testing.assert_allclose(mine, np.asarray(j_ref(q, k, v)), atol=1e-6)
    # the kernel's order of operations gives the same numbers in f32
    plain = _np(attention_plain(*(torch.from_numpy(a) for a in (qp, kp, vp)), nh))
    np.testing.assert_allclose(plain.reshape(b, t, nh, -1)[..., :hd], mine, atol=1e-6)


@pytest.mark.parametrize("kind", ["exact", "tanh"])
def test_ln_gelu_matches_pallas_interpret(rng, kind):
    """Plain version of kernel D ([B, C, L] layout) vs the Pallas LN+GELU
    ([B, L, C]) in interpret mode at [2, 300, 512], atol 2e-5."""
    from xai_audio_deepfakes_tpu.ops.pallas_ln_gelu import ln_gelu as j_ln_gelu

    x = rng.standard_normal((2, 300, 512)).astype(np.float32) * 2.0 + 0.5
    g = (1.0 + 0.1 * rng.standard_normal(512)).astype(np.float32)
    lb = (0.1 * rng.standard_normal(512)).astype(np.float32)
    ref = np.asarray(j_ln_gelu(jnp.asarray(x), jnp.asarray(g), jnp.asarray(lb), 1e-5, kind,
                               jnp.float32, True))
    xt = torch.from_numpy(x).transpose(1, 2).contiguous()
    out = ln_gelu_(xt, torch.from_numpy(g), torch.from_numpy(lb), 1e-5, kind)
    assert out.data_ptr() == xt.data_ptr()  # written in place
    np.testing.assert_allclose(_np(out).transpose(0, 2, 1), ref, atol=2e-5)
