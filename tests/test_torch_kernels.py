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
from xai_audio_deepfakes_tpu_torch.ops.cuda_conv import conv_ln_gelu, conv_ln_gelu_plain
from xai_audio_deepfakes_tpu_torch.ops.cuda_ln_gelu import ln_gelu, ln_gelu_, ln_gelu_plain
from xai_audio_deepfakes_tpu_torch.ops.cuda_pos_conv import (
    grad_weight,
    pos_conv,
    pos_conv_dgrad_op,
    pos_conv_grad_image,
    pos_conv_image,
    pos_conv_plain,
)
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
    # full-f32 plain versions: cuDNN's f32 convolutions default to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 0.0), (torch.bfloat16, 1e-2, 1e-2)])
@pytest.mark.parametrize("b,t,nh", [(2, 1, 4), (2, 15, 4), (2, 64, 4), (2, 200, 4), (2, 249, 4),
                                    (2, 249, 16)])
def test_attention_kernel_ragged_t_and_training_shape(rng, cuda, dtype, atol, rtol, b, t, nh):
    """Both bodies at key counts that leave a partial 64-key chunk (or none),
    and at the training step's shape (2 clips, 16 heads); pad lanes stay
    exactly zero."""
    hd = 120
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in _padded_qkv(rng, b, t, nh, hd))
    out = attention(q, k, v, nh)
    torch.testing.assert_close(out.float(), attention_plain(q, k, v, nh).float(), atol=atol, rtol=rtol)
    assert not out.reshape(b, t, nh, -1)[..., hd:].any()


@pytest.mark.gpu
def test_attention_bf16_body_streams_past_the_f32_tile(rng, cuda):
    """The bf16 body streams the keys, so T may exceed what the f32 body's
    shared-memory score tile holds."""
    from xai_audio_deepfakes_tpu_torch.ops import _cuda

    t = _cuda.library().addv_attention_max_t() + 100
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in _padded_qkv(rng, 1, t, 2, 120))
    out = attention(q, k, v, 2)
    torch.testing.assert_close(out.float(), attention_plain(q, k, v, 2).float(), atol=1e-2, rtol=1e-2)
    with pytest.raises(ValueError, match="f32 body"):
        attention(q.float(), k.float(), v.float(), 2)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("length", [8000, 80000, 80001])
def test_stft_fft_body_matches_plain(rng, cuda, batch, length):
    """The FFT body (n_fft 1024) with the reflect pad folded into its read,
    one launch, against the matmul DFT of `stft_plain` (2e-4)."""
    from xai_audio_deepfakes_tpu_torch.ops import _cuda

    x = torch.from_numpy(rng.standard_normal((batch, length)).astype(np.float32) * 0.3).to(cuda)
    before = _cuda.LAUNCHES["stft"]
    re, im = t_stft(x, CFG)
    assert _cuda.LAUNCHES["stft"] == before + 1
    assert re.shape == im.shape == (batch, CFG.num_bins, 1 + length // CFG.hop_length)
    re_p, im_p = stft.stft_plain(x, CFG)
    torch.testing.assert_close(re, re_p, atol=2e-4, rtol=0)
    torch.testing.assert_close(im, im_p, atol=2e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [STFTConfig(n_fft=640, win_length=640),
                                 STFTConfig(n_fft=512, hop_length=128, win_length=400, window="hann"),
                                 STFTConfig(center=False)],
                         ids=["dft_body_640", "fft_512_hann", "fft_uncentred"])
def test_stft_other_configs_match_plain(rng, cuda, cfg):
    """n_fft 640 goes through the kept direct-DFT body; the uncentred case
    takes no pad at all."""
    x = torch.from_numpy(rng.standard_normal((2, 16000)).astype(np.float32) * 0.3).to(cuda)
    re, im = t_stft(x, cfg)
    re_p, im_p = stft.stft_plain(x, cfg)
    torch.testing.assert_close(re, re_p, atol=2e-4, rtol=0)
    torch.testing.assert_close(im, im_p, atol=2e-4, rtol=0)


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


ISTFT_512 = STFTConfig(n_fft=512, hop_length=128, win_length=400, window="hann")


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("length", [8000, 80000, 80001])
@pytest.mark.parametrize("cfg", [CFG, ISTFT_512], ids=["fft_1024", "fft_512_hann"])
def test_istft_fft_body_matches_plain(rng, cuda, batch, length, cfg):
    """Kernel C's FFT body, one launch, against the matmul inverse DFT of
    `istft_plain` (2e-4) on randn spectra, whose Im[0] and Im[M] are
    non-zero (the plain version's bases ignore them)."""
    from xai_audio_deepfakes_tpu_torch.ops import _cuda
    from xai_audio_deepfakes_tpu_torch.ops.cuda_stft import istft_uses_fft

    assert istft_uses_fft(cfg.n_fft, cfg.hop_length)
    t = 1 + length // cfg.hop_length
    re, im = (torch.from_numpy(rng.standard_normal((batch, cfg.num_bins, t)).astype(np.float32))
              .to(cuda) for _ in range(2))
    before = _cuda.LAUNCHES["istft"]
    y = t_istft(re, im, cfg, length)
    assert _cuda.LAUNCHES["istft"] == before + 1
    assert y.shape == (batch, length)
    torch.testing.assert_close(y, stft.istft_plain(re, im, cfg, length), atol=2e-4, rtol=0)


@pytest.mark.gpu
def test_istft_dft_body_matches_plain(rng, cuda):
    """n_fft 640 keeps kernel C's direct-DFT body."""
    from xai_audio_deepfakes_tpu_torch.ops.cuda_stft import istft_uses_fft

    cfg = STFTConfig(n_fft=640, win_length=640)
    assert not istft_uses_fft(cfg.n_fft, cfg.hop_length)
    re, im = (torch.from_numpy(rng.standard_normal((2, cfg.num_bins, 50)).astype(np.float32))
              .to(cuda) for _ in range(2))
    length = 49 * cfg.hop_length
    torch.testing.assert_close(t_istft(re, im, cfg, length),
                               stft.istft_plain(re, im, cfg, length), atol=2e-4, rtol=0)


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


FRONTEND_LENGTHS = [15999, 7999, 3999, 1999, 999, 499, 249]
LN_GELU_BARS = [(torch.float32, 2e-5, 0.0), (torch.bfloat16, 1e-2, 1e-2)]


def _ln_gelu_inputs(rng, device, dtype, b, c, length):
    """x ~ 2 N(0, 1) + 0.5 (drawn on the device from a seed of `rng`, since
    the frontend shapes hold up to 2e8 elements), scale ~ 1 + 0.1 N, bias ~
    0.1 N."""
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(2**31)))
    x = (torch.randn(b, c, length, device=device, generator=gen) * 2 + 0.5).to(dtype)
    g = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(np.float32)).to(device)
    lb = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32)).to(device)
    return x, g, lb


def _bf16_steps(got, want):
    """|got - want| in units of one bf16 step (2^-7 of want's power of two)."""
    got, want = got.float(), want.float()
    _, e = torch.frexp(want)
    return (got - want).abs() / torch.ldexp(torch.ones_like(want), e - 8)


def _assert_ln_gelu_close(got, want, dtype, atol, rtol):
    """The kernel's bar, and in bf16 at most 0.1% of the elements more than
    one bf16 step off: the kernel's f32 sums run in another order than the
    plain version's, so a normalised value now and then rounds to the
    neighbouring bf16 value before the GELU."""
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    if dtype == torch.bfloat16:
        assert float((_bf16_steps(got, want) > 1).float().mean()) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", LN_GELU_BARS)
@pytest.mark.parametrize("kind", ["exact", "tanh"])
@pytest.mark.parametrize("batch", [2, 24])
@pytest.mark.parametrize("length", FRONTEND_LENGTHS)
def test_ln_gelu_kernel_frontend_shapes(rng, cuda, dtype, atol, rtol, kind, batch, length):
    """Kernel D in place at the seven frontend layers' shapes (C = 512, odd
    lengths, so every channel row starts at its own residue modulo 16 bytes),
    at the training step's batch and the explain's embedder batch."""
    x, g, lb = _ln_gelu_inputs(rng, cuda, dtype, batch, 512, length)
    want = ln_gelu_plain(x, g, lb, 1e-5, kind)
    got = ln_gelu_(x, g, lb, 1e-5, kind)
    assert got.data_ptr() == x.data_ptr()
    _assert_ln_gelu_close(got, want, dtype, atol, rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", LN_GELU_BARS)
@pytest.mark.parametrize("c,length", [(8, 1), (8, 7), (8, 9), (8, 249), (8, 15999), (1, 33),
                                      (100, 37), (511, 65), (512, 1), (512, 7)])
def test_ln_gelu_kernel_small_c_and_ragged_l(rng, cuda, dtype, atol, rtol, c, length):
    """Any C up to 512 (the tiny embedder's C = 8 among them) and lengths
    shorter than one 32-frame tile, or with a ragged last tile; in place and
    out of place."""
    x, g, lb = _ln_gelu_inputs(rng, cuda, dtype, 3, c, length)
    want = ln_gelu_plain(x, g, lb, 1e-5, "exact")
    kept = x.clone()
    out = ln_gelu(x, g.requires_grad_(), lb, 1e-5, "exact")  # out of place (a gradient is recorded)
    assert out.data_ptr() != x.data_ptr() and torch.equal(x, kept)
    _assert_ln_gelu_close(out.detach(), want, dtype, atol, rtol)
    _assert_ln_gelu_close(ln_gelu_(x, g.detach(), lb, 1e-5, "exact"), want, dtype, atol, rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", LN_GELU_BARS)
@pytest.mark.parametrize("offset", [1, 3, 7])
@pytest.mark.parametrize("in_place", [True, False], ids=["in_place", "out_of_place"])
def test_ln_gelu_kernel_storage_offset(rng, cuda, dtype, atol, rtol, offset, in_place):
    """A contiguous view with a storage offset, whose data pointer is not 16
    bytes aligned: the kernel reads and writes at the pointer's own residue
    (out of place, x's and the fresh output's residues differ), and in place
    it leaves the buffer around the view untouched."""
    b, c, length = 2, 512, 999
    x0, g, lb = _ln_gelu_inputs(rng, cuda, dtype, b, c, length)
    buf = torch.full((b * c * length + offset + 5,), 7.0, device=cuda, dtype=dtype)
    x = buf[offset:offset + x0.numel()].view(b, c, length)
    x.copy_(x0)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    want = ln_gelu_plain(x0, g, lb, 1e-5, "tanh")
    if in_place:
        got = ln_gelu_(x, g, lb, 1e-5, "tanh")
        assert got.data_ptr() == x.data_ptr()
        assert bool((buf[:offset] == 7).all()) and bool((buf[offset + x0.numel():] == 7).all())
    else:
        got = ln_gelu(x, g.requires_grad_(), lb, 1e-5, "tanh").detach()
        assert torch.equal(x, x0)
    _assert_ln_gelu_close(got, want, dtype, atol, rtol)


def _conv_inputs(rng, device, dtype, k, length, batch=2, c=512):
    x = torch.from_numpy(rng.standard_normal((batch, c, length)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((c, c, k)).astype(np.float32) * (c * k) ** -0.5)
    cb, lb = (torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.1) for _ in range(2))
    g = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(np.float32))
    return x.to(device, dtype), w.to(device, dtype), cb.to(device, dtype), g.to(device), lb.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 0.0), (torch.bfloat16, 1e-2, 3.2e-2)])
@pytest.mark.parametrize("k,length,c,kind", [(3, 999, 512, "exact"), (2, 499, 512, "tanh"),
                                             (3, 66, 128, "exact"), (2, 33, 256, "exact")])
def test_conv_ln_gelu_kernel_matches_plain(rng, cuda, dtype, atol, rtol, k, length, c, kind):
    """Kernel E against its plain version: f32 sums of 3 * 512 products in
    another order (2e-5). In bf16 a conv sum may round to the neighbouring
    bf16 value (the tensor cores' f32 sums differ from cuDNN's in the last
    bits), and that step passes through two more roundings: up to four bf16
    steps, 3.2e-2 of |y|, on at most 0.1% of the elements; the rest are
    within one step."""
    x, w, cb, g, lb = _conv_inputs(rng, cuda, dtype, k, length, c=c)
    got = conv_ln_gelu(x, w, cb, g, lb, 1e-5, kind)
    want = conv_ln_gelu_plain(x, w, cb, g, lb, 1e-5, kind)
    assert got.shape == want.shape == (2, c, (length - k) // 2 + 1)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    off = (got.float() - want.float()).abs() > 1e-2 + 1e-2 * want.float().abs()
    assert float(off.float().mean()) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 0.0), (torch.bfloat16, 1e-2, 3.2e-2)])
@pytest.mark.parametrize("batch", [2, 24])
@pytest.mark.parametrize("k,length", [(3, 15999), (3, 7999), (3, 3999), (3, 1999), (2, 999), (2, 499)])
def test_conv_ln_gelu_kernel_frontend_shapes(rng, cuda, dtype, atol, rtol, batch, k, length):
    """Kernel E at the six frontend layers' shapes (inputs 15999 .. 499
    frames, outputs 7999 .. 249, ragged last 64-frame tiles), at the
    training step's batch and the explain's, against its plain version at
    the bar of `test_conv_ln_gelu_kernel_matches_plain`."""
    x, w, cb, g, lb = _conv_inputs(rng, cuda, dtype, k, length, batch=batch)
    got = conv_ln_gelu(x, w, cb, g, lb, 1e-5, "exact")
    want = conv_ln_gelu_plain(x, w, cb, g, lb, 1e-5, "exact")
    assert got.shape == want.shape == (batch, 512, (length - k) // 2 + 1)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    off = (got.float() - want.float()).abs() > 1e-2 + 1e-2 * want.float().abs()
    assert float(off.float().mean()) <= 1e-3


def _grads(fn, tensors):
    leaves = [t.detach().clone().requires_grad_() for t in tensors]
    out = fn(*leaves)
    (out.float() ** 2).sum().backward()
    return [t.grad for t in leaves]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["attention", "istft", "ln_gelu", "conv_ln_gelu"])
def test_kernel_backward_matches_autograd_through_plain(rng, cuda, name):
    """Forward through the kernel, backward by recomputation: the gradients
    equal autograd through the plain version (f32; 1e-4 of the gradient's
    scale, the two differ by the order of f32 sums)."""
    if name == "attention":
        tensors = [torch.from_numpy(a).to(cuda) for a in _padded_qkv(rng, 2, 249, 4, 120)]
        fn, plain = (lambda q, k, v: attention(q, k, v, 4)), (lambda q, k, v: attention_plain(q, k, v, 4))
    elif name == "istft":
        tensors = [torch.from_numpy(rng.standard_normal((2, 513, 249)).astype(np.float32)).to(cuda)
                   for _ in range(2)]
        fn = lambda re, im: t_istft(re, im, CFG, 80000)  # noqa: E731
        plain = lambda re, im: stft.istft_plain(re, im, CFG, 80000)  # noqa: E731
    elif name == "ln_gelu":
        x, _, _, g, lb = _conv_inputs(rng, cuda, torch.float32, 3, 999)
        tensors = [x, g, lb]
        fn = lambda x, g, lb: ln_gelu(x * 1.0, g, lb, 1e-5, "exact")  # noqa: E731
        plain = lambda x, g, lb: ln_gelu_plain(x, g, lb, 1e-5, "exact")  # noqa: E731
    else:
        tensors = list(_conv_inputs(rng, cuda, torch.float32, 3, 999))
        fn = lambda *a: conv_ln_gelu(*a, 1e-5, "exact")  # noqa: E731
        plain = lambda *a: conv_ln_gelu_plain(*a, 1e-5, "exact")  # noqa: E731
    for got, want in zip(_grads(fn, tensors), _grads(plain, tensors)):
        torch.testing.assert_close(got, want, atol=1e-4 * float(want.abs().max()), rtol=0)


# kernel F: XLS-R's grouped positional conv, [B, T, 1920], k 128, 16 groups
POS_H, POS_K, POS_G = 1920, 128, 16


def _pos_conv_inputs(rng, device, b, t, h=POS_H, k=POS_K, groups=POS_G):
    cg = h // groups
    x = torch.from_numpy(rng.standard_normal((b, t, h)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((h, cg, k)).astype(np.float32) * (cg * k) ** -0.5)
    bias = torch.from_numpy(rng.standard_normal(h).astype(np.float32) * 0.1)
    return (x.to(device, torch.bfloat16), w.to(device, torch.bfloat16),
            bias.to(device, torch.bfloat16))


def _one_step_close(got, want):
    """Within two bf16 steps (the tensor cores' f32 sums round now and then
    to the neighbouring bf16 value, and the bias add rounds once more), and
    at most 0.1% of the elements more than one step off."""
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, atol=1e-2, rtol=1.6e-2)
    assert float(((got - want).abs() > 1e-2 + 2 ** -8 * want.abs()).float().mean()) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("b,t", [(16, 249), (192, 249), (2, 1), (2, 100), (3, 257), (2, 600)])
def test_pos_conv_kernel_matches_plain(rng, cuda, b, t):
    """Kernel F's forward (pad 64, the trailing frame never computed) and
    its input gradient (the flipped image, pad 63) against the plain
    versions, at a training step's embed, an offline explain's and ragged
    lengths."""
    x, w, bias = _pos_conv_inputs(rng, cuda, b, t)
    _one_step_close(pos_conv(x, w, bias, POS_K // 2), pos_conv_plain(x, w, bias, POS_K // 2, t))
    grad = pos_conv_dgrad_op(x, pos_conv_grad_image(w), POS_K, POS_K - 1 - POS_K // 2)
    _one_step_close(grad, pos_conv_plain(x, grad_weight(w), None, POS_K - 1 - POS_K // 2, t))


@pytest.mark.gpu
@pytest.mark.parametrize("h,groups,k,t", [(32, 2, 16, 40), (48, 2, 5, 300), (240, 2, 128, 70)])
def test_pos_conv_kernel_other_widths(rng, cuda, h, groups, k, t):
    """Narrower groups (16 and 24 channels: zero columns in the image, an
    odd k) and XLS-R's width at two groups, forward and input gradient."""
    x, w, bias = _pos_conv_inputs(rng, cuda, 2, t, h, k, groups)
    _one_step_close(pos_conv(x, w, bias, k // 2), pos_conv_plain(x, w, bias, k // 2, t))
    gimg = pos_conv_grad_image(w)
    _one_step_close(pos_conv_dgrad_op(x, gimg, k, k - 1 - k // 2),
                    pos_conv_plain(x, grad_weight(w), None, k - 1 - k // 2, t))


@pytest.mark.gpu
def test_pos_conv_gradient_is_deterministic_and_flows(rng, cuda):
    """Two gradient launches are bit for bit equal; through the autograd
    function the input gradient is the kernel's on the gradient image."""
    x, w, bias = _pos_conv_inputs(rng, cuda, 16, 249)
    gimg = pos_conv_grad_image(w)
    first = pos_conv_dgrad_op(x, gimg, POS_K, POS_K // 2 - 1)
    assert torch.equal(first, pos_conv_dgrad_op(x, gimg, POS_K, POS_K // 2 - 1))
    xg = x.clone().requires_grad_()
    y = pos_conv(xg, w, bias, POS_K // 2, pos_conv_image(w), gimg)
    y.backward(x)
    assert torch.equal(xg.grad, first)
