"""PyTorch port, kernel B's FFT plan on the CPU: a numpy emulation of the
algorithm in `csrc/stft.cu::stft_fft_kernel`, in f32 as the kernel computes,
against `np.fft.rfft` and against the kernel's plain version `stft_plain`.

The emulation follows the kernel step by step: the reflect pad folded into
the frame read, the even/odd packing z[n] = x[2n] + i x[2n + 1], the
Stockham stages (radix 8, then one radix-4 or radix-2 stage) with twiddles
from the package's own table (`ops/stft.py::_fft_twiddles`), and the split
step that gives bins 0 .. n_fft / 2. The kernel itself runs only on the card
(`tests/test_torch_kernels.py`). This file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from xai_audio_deepfakes_tpu_torch.config import STFTConfig
from xai_audio_deepfakes_tpu_torch.ops import _cuda, stft
from xai_audio_deepfakes_tpu_torch.ops.cuda_stft import uses_fft

C8 = np.float32(0.70710678118654752)


def _cplx(re, im):
    out = np.empty(np.shape(re), np.complex64)
    out.real, out.imag = re, im
    return out


def _mul_neg_i(a):
    return _cplx(a.imag, -a.real)


def _dft(v):
    """The kernel's in-register DFT of R = len(v) points (`dft<R>`)."""
    if len(v) == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if len(v) == 4:
        t0, t1 = v[0] + v[2], v[0] - v[2]
        t2, t3 = v[1] + v[3], _mul_neg_i(v[1] - v[3])
        return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]
    e, o = _dft(v[0::2]), _dft(v[1::2])
    o[1] = _cplx(C8 * (o[1].real + o[1].imag), C8 * (o[1].imag - o[1].real))
    o[2] = _mul_neg_i(o[2])
    o[3] = _cplx(C8 * (o[3].imag - o[3].real), -C8 * (o[3].real + o[3].imag))
    return [e[k] + o[k] for k in range(4)] + [e[k] - o[k] for k in range(4)]


def _radices(m: int) -> list[int]:
    """The kernel's stage plan for an m-point FFT."""
    out, ns = [], 1
    while ns < m:
        left = m // ns
        out.append(8 if left >= 8 else left)
        ns *= out[-1]
    return out


def _fft_stage(y, r, ns, tw, n_fft):
    """`fft_stage<R>`: butterfly j reads y[j + q m / R], twiddles by
    W^{q k n_fft / (ns R)}, k = j mod ns, writes to (j - k) R + k + q ns."""
    m = y.shape[-1]
    per = m // r
    j = np.arange(per)
    k = j % ns
    v = [y[:, j + q * per] for q in range(r)]
    v = [v[0]] + [v[q] * tw[q * k * (n_fft // (ns * r))] for q in range(1, r)]
    v = _dft(v)
    out = np.empty_like(y)
    for q in range(r):
        out[:, (j - k) * r + k + q * ns] = v[q]
    return out


def _frames(x, cfg):
    """The kernel's read: frame t's padded sample p is x[p - pad], reflected
    at both ends, times the window. [L] -> [T, n_fft] f32."""
    n_fft, hop, pad = cfg.n_fft, cfg.hop_length, cfg.n_fft // 2
    t_len = 1 + (len(x) + 2 * pad - n_fft) // hop
    i = (np.arange(t_len)[:, None] * hop + np.arange(n_fft)[None, :]) - pad
    i = np.where(i < 0, -i, np.where(i >= len(x), 2 * len(x) - 2 - i, i))
    win = stft.device_constant("window", torch.device("cpu"), cfg.window, cfg.win_length, n_fft)
    return x[i] * win.numpy()


def fft_stft(x, cfg):
    """Emulated kernel B, one signal [L] -> (re, im) [bins, T]."""
    n_fft, m = cfg.n_fft, cfg.n_fft // 2
    tab = stft._fft_twiddles(n_fft)
    tw = _cplx(tab[:, 0], tab[:, 1])
    fr = _frames(x, cfg)
    y = _cplx(fr[:, 0::2], fr[:, 1::2])  # [T, m]
    ns = 1
    for r in _radices(m):
        y = _fft_stage(y, r, ns, tw, n_fft)
        ns *= r
    k = np.arange(m + 1)
    zk, zr = y[:, k % m], y[:, (m - k) % m]
    s = _cplx(zk.real + zr.real, zk.imag - zr.imag)
    d = _cplx(zk.real - zr.real, zk.imag + zr.imag)
    w = d * tw[k]
    re = np.float32(0.5) * (s.real + w.imag)
    im = np.float32(0.5) * (s.imag - w.real)
    return re.T, im.T


CONFIGS = {
    1024: STFTConfig(),
    512: STFTConfig(n_fft=512, hop_length=128, win_length=400, window="hann"),
}


@pytest.mark.parametrize("n_fft", [1024, 512])
def test_fft_plan_matches_rfft_and_stft_plain(rng, n_fft):
    """1e-5 on bins up to ~9 in magnitude: f32 sums in two orders (log2 N
    stages against one n_fft-term product). The emulated FFT is within 1e-6
    of rfft; most of the gap to `stft_plain` is the product's own rounding."""
    cfg = CONFIGS[n_fft]
    x = (rng.standard_normal((2, 8000)) * 0.1).astype(np.float32)
    re_p, im_p = stft.stft_plain(torch.from_numpy(x), cfg)
    for b in range(2):
        re, im = fft_stft(x[b], cfg)
        want = np.fft.rfft(_frames(x[b], cfg).astype(np.float64), axis=-1).T
        np.testing.assert_allclose(re, want.real, atol=1e-5, rtol=0)
        np.testing.assert_allclose(im, want.imag, atol=1e-5, rtol=0)
        np.testing.assert_allclose(re, re_p[b].numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(im, im_p[b].numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_fft", [1024, 512])
def test_fft_split_edge_bins(rng, n_fft):
    """Bin 0 is the frame's sum and bin n_fft/2 its alternating sum, both
    real: the split step's Z[M] = Z[0] and Z*[M - 0] = Z*[0] cases."""
    cfg = CONFIGS[n_fft]
    x = (rng.standard_normal(4000) * 0.3).astype(np.float32)
    re, im = fft_stft(x, cfg)
    fr = _frames(x, cfg).astype(np.float64)
    sign = (-1.0) ** np.arange(n_fft)
    np.testing.assert_allclose(re[0], fr.sum(-1), atol=1e-5, rtol=0)
    np.testing.assert_allclose(re[-1], (fr * sign).sum(-1), atol=1e-5, rtol=0)
    np.testing.assert_allclose(im[0], 0.0, atol=1e-5)
    np.testing.assert_allclose(im[-1], 0.0, atol=1e-5)


@pytest.mark.parametrize("n_fft", [2, 8, 64, 2048])
def test_fft_plan_other_powers_of_two(rng, n_fft):
    """The plan's last radix-4 or radix-2 stage, and n_fft 2 with no stage."""
    cfg = STFTConfig(n_fft=n_fft, hop_length=max(1, n_fft // 4), win_length=n_fft, window="hann")
    x = (rng.standard_normal(3 * n_fft) * 0.3).astype(np.float32)
    re, im = fft_stft(x, cfg)
    want = np.fft.rfft(_frames(x, cfg).astype(np.float64), axis=-1).T
    np.testing.assert_allclose(re, want.real, atol=1e-5, rtol=0)
    np.testing.assert_allclose(im, want.imag, atol=1e-5, rtol=0)
    assert np.prod(_radices(n_fft // 2)) == n_fft // 2


def test_frame_read_folds_the_reflect_pad(rng):
    """The kernel's reflected index reads what `pad_signal` (F.pad, reflect)
    and unfold give, at both ends of the signal."""
    cfg = STFTConfig()
    x = rng.standard_normal(3000).astype(np.float32)
    xp = stft.pad_signal(torch.from_numpy(x)[None], cfg)[0]
    win = stft.device_constant("window", torch.device("cpu"), cfg.window, cfg.win_length, cfg.n_fft)
    want = (xp.unfold(-1, cfg.n_fft, cfg.hop_length) * win).numpy()
    np.testing.assert_array_equal(_frames(x, cfg), want)


@pytest.mark.parametrize("n_fft,fft", [(1024, True), (512, True), (2, True), (8192, True),
                                       (640, False), (1000, False), (16384, False)])
def test_stft_body_choice(n_fft, fft):
    assert uses_fft(n_fft) is fft


def test_twiddle_table_is_the_float64_root_of_unity():
    tab = stft._fft_twiddles(1024)
    assert tab.shape == (1024, 2) and tab.dtype == np.float32
    ang = 2 * np.pi * np.arange(1024) / 1024
    np.testing.assert_array_equal(tab[:, 0], np.cos(ang).astype(np.float32))
    np.testing.assert_array_equal(tab[:, 1], (-np.sin(ang)).astype(np.float32))


def test_sources_hash_covers_every_header(tmp_path, monkeypatch):
    """An edited header under csrc/ changes the library's name, so the card
    never runs a library built from a stale header."""
    for src in _cuda.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    before = _cuda._sources_hash()
    (tmp_path / "extra.cuh").write_text("// a new header\n")
    with_header = _cuda._sources_hash()
    (tmp_path / "extra.cuh").write_text("// an edited header\n")
    assert len({before, with_header, _cuda._sources_hash()}) == 3
