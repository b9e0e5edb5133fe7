"""PyTorch port, the FFT plans of kernels B and C on the CPU: numpy
emulations of `csrc/stft.cu::stft_fft_kernel` and
`csrc/istft.cu::istft_fft_kernel`, in f32 as the kernels compute, against
`np.fft.rfft` / `np.fft.irfft` and against the kernels' plain versions
`stft_plain` / `istft_plain`.

The emulations follow the kernels step by step. B: the reflect pad folded
into the frame read, the even/odd packing z[n] = x[2n] + i x[2n + 1], the
Stockham stages of `csrc/fft.cuh` (radix 8, then one radix-4 or radix-2
stage) with twiddles from the package's own table
(`ops/stft.py::_fft_twiddles`), and the split step that gives bins
0 .. n_fft / 2. C: Im[0] and Im[n_fft / 2] dropped, the half-length pack,
the inverse FFT as conj(FFT(conj(Z))) on the same stages, the window, the
span-wise gather overlap-add in chunks of frames, the envelope, the trim and
the crop or zero-pad. The kernels themselves run only on the card
(`tests/test_torch_kernels.py`). This file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from xai_audio_deepfakes_tpu_torch.config import STFTConfig
from xai_audio_deepfakes_tpu_torch.ops import _cuda, stft
from xai_audio_deepfakes_tpu_torch.ops.cuda_stft import istft_uses_fft, uses_fft

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


def _twiddles(n_fft):
    tab = stft._fft_twiddles(n_fft)
    return _cplx(tab[:, 0], tab[:, 1])


def _fft(y, tw, n_fft):
    """`fft_all_stages`: the forward FFT of each row of y [frames, m]."""
    ns = 1
    for r in _radices(y.shape[-1]):
        y = _fft_stage(y, r, ns, tw, n_fft)
        ns *= r
    return y


def fft_stft(x, cfg):
    """Emulated kernel B, one signal [L] -> (re, im) [bins, T]."""
    n_fft, m = cfg.n_fft, cfg.n_fft // 2
    tw = _twiddles(n_fft)
    fr = _frames(x, cfg)
    y = _fft(_cplx(fr[:, 0::2], fr[:, 1::2]), tw, n_fft)  # [T, m]
    k = np.arange(m + 1)
    zk, zr = y[:, k % m], y[:, (m - k) % m]
    s = _cplx(zk.real + zr.real, zk.imag - zr.imag)
    d = _cplx(zk.real - zr.real, zk.imag + zr.imag)
    w = d * tw[k]
    re = np.float32(0.5) * (s.real + w.imag)
    im = np.float32(0.5) * (s.imag - w.real)
    return re.T, im.T


def istft_chunk(n_fft: int, hop: int) -> tuple[int, int]:
    """Kernel C's tiling as `addv_istft_fft` picks it: (span in padded
    samples, frames per chunk)."""
    frames = max(1, min(8, 8192 // n_fft))
    fixed = 8 * n_fft + 4 * frames * hop
    per_frame = 16 * (n_fft // 2 + 1)
    return frames * hop, min(frames + (n_fft - 1) // hop, (220 * 1024 - fixed) // per_frame)


def fft_istft(re, im, cfg, length, chunk=None):
    """Emulated kernel C, one clip (re, im) [bins, T] -> [length]."""
    n_fft, hop, m = cfg.n_fft, cfg.hop_length, cfg.n_fft // 2
    t_len = re.shape[-1]
    span, auto_chunk = istft_chunk(n_fft, hop)
    chunk = chunk or auto_chunk
    tw = _twiddles(n_fft)
    win = stft.device_constant("window", torch.device("cpu"), cfg.window, cfg.win_length, n_fft)
    win = win.numpy()
    env = stft._ola_envelope(t_len, n_fft, hop, cfg.window, cfg.win_length)
    padded_len = n_fft + hop * (t_len - 1)
    offset = n_fft // 2 if cfg.center else 0
    inv_n = np.float32(1.0 / n_fft)
    k = np.arange(m)
    w_inv = np.conj(tw[:m])  # W^{-k}
    y = np.zeros(length, np.float32)
    for j in range(offset // span, -(-(offset + length) // span)):
        p0 = j * span
        t_first = 0 if p0 - n_fft + 1 <= 0 else (p0 - n_fft + hop) // hop
        t_last = min(t_len - 1, (p0 + span - 1) // hop)
        acc = np.zeros(span, np.float32)
        for c0 in range(t_first, t_last + 1, chunk):
            g = min(chunk, t_last - c0 + 1)
            x = _cplx(re[:, c0:c0 + g].T, im[:, c0:c0 + g].T)  # [g, bins]
            x.imag[:, 0] = x.imag[:, m] = 0  # Im[0] and Im[M] dropped
            xk, xr = x[:, k], x[:, m - k]
            sm = _cplx(xk.real + xr.real, xk.imag - xr.imag)
            dif = _cplx(xk.real - xr.real, xk.imag + xr.imag)
            q = dif * w_inv
            z = _fft(_cplx(sm.real - q.imag, -(sm.imag + q.real)), tw, n_fft)  # [g, m]
            for i in range(span):
                p = p0 + i
                if p >= padded_len:
                    continue
                t_lo = max(c0, 0 if p - n_fft + 1 <= 0 else (p - n_fft + hop) // hop)
                for t in range(t_lo, min(c0 + g - 1, p // hop) + 1):
                    n = p - t * hop
                    v = z[t - c0, n // 2]
                    acc[i] += win[n] * ((-v.imag if n & 1 else v.real) * inv_n)
        for i in range(span):
            p, o = p0 + i, p0 + i - offset
            if 0 <= o < length and p < padded_len:
                y[o] = acc[i] / (env[p] if env[p] > 1e-11 else np.float32(1))
    return y


def _spectra(rng, cfg, t_len, batch=1):
    """randn spectra; Im[0] and Im[M] are non-zero, as a gradient's are."""
    shape = (batch, cfg.num_bins, t_len)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _irfft_istft(re, im, cfg, length):
    """Reference by np.fft.irfft in float64 (Im[0], Im[M] dropped), window,
    overlap-add, envelope, trim, crop / pad."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    spec = re.astype(np.float64) + 1j * im.astype(np.float64)
    spec[0].imag = spec[-1].imag = 0
    frames = np.fft.irfft(spec.T, n=n_fft, axis=-1)
    win = stft.device_constant("window", torch.device("cpu"), cfg.window, cfg.win_length, n_fft)
    frames = frames * win.numpy().astype(np.float64)
    t_len = re.shape[-1]
    out = np.zeros(n_fft + hop * (t_len - 1))
    for t in range(t_len):
        out[t * hop:t * hop + n_fft] += frames[t]
    env = stft._ola_envelope(t_len, n_fft, hop, cfg.window, cfg.win_length)
    out = out / np.where(env > 1e-11, env, 1.0)
    if cfg.center:
        out = out[n_fft // 2:]
    return np.pad(out, (0, max(0, length - len(out))))[:length]


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


@pytest.mark.parametrize("n_fft,hop,fft", [(1024, 322, True), (512, 128, True), (8192, 8192, True),
                                           (640, 160, False), (1024, 1025, False)])
def test_istft_body_choice(n_fft, hop, fft):
    """Kernel C's FFT body takes a power-of-two n_fft whose frames overlap
    or meet; a 640-point frame keeps the direct DFT."""
    assert istft_uses_fft(n_fft, hop) is fft


# f32 sums in another order than the plain version's 513-term products and
# than float64 irfft: 2e-6 on samples up to ~0.3, and 1e-5 of the value
# where a tail's tiny window-square envelope scales samples up to ~200 (the
# kernel's bar on the card is 2e-4 on the main path's shapes)
ISTFT_TOL = dict(atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("n_fft", [1024, 512])
@pytest.mark.parametrize("length", [8000, 7000, 9000], ids=["same", "shorter", "longer"])
def test_istft_fft_plan_matches_plain_and_irfft(rng, n_fft, length):
    """Kernel C's plan against `istft_plain` and irfft on spectra with
    non-zero Im[0] and Im[M]; 8000 samples leave a ragged last span, 7000
    crops the trimmed signal and 9000 zero-pads it."""
    cfg = CONFIGS[n_fft]
    t_len = 1 + 8000 // cfg.hop_length
    re, im = _spectra(rng, cfg, t_len)
    want = stft.istft_plain(torch.from_numpy(re), torch.from_numpy(im), cfg, length)[0].numpy()
    got = fft_istft(re[0], im[0], cfg, length)
    assert got.shape == (length,)
    np.testing.assert_allclose(got, want, **ISTFT_TOL)
    np.testing.assert_allclose(got, _irfft_istft(re[0], im[0], cfg, length), **ISTFT_TOL)
    if length > 8000:
        assert not got[8000 + cfg.n_fft // 2:].any()


def test_istft_fft_plan_ignores_im_of_the_edge_bins(rng):
    """Im[0] and Im[M] change neither the plan's output nor the plain one's."""
    cfg = CONFIGS[512]
    re, im = _spectra(rng, cfg, 20)
    im_zero = im.copy()
    im_zero[:, 0] = im_zero[:, -1] = 0
    length = 19 * cfg.hop_length
    np.testing.assert_array_equal(fft_istft(re[0], im[0], cfg, length),
                                  fft_istft(re[0], im_zero[0], cfg, length))
    plain = [stft.istft_plain(torch.from_numpy(re), torch.from_numpy(i), cfg, length)
             for i in (im, im_zero)]
    torch.testing.assert_close(plain[0], plain[1], atol=1e-6, rtol=0)


def test_istft_fft_plan_in_small_chunks(rng):
    """Fewer frames a chunk than touch a span (as at n_fft 8192): the span's
    accumulator carries across chunks."""
    cfg = CONFIGS[1024]
    re, im = _spectra(rng, cfg, 20)
    span, chunk = istft_chunk(cfg.n_fft, cfg.hop_length)
    assert (span, chunk) == (8 * 322, 11)
    length = 19 * cfg.hop_length
    want = stft.istft_plain(torch.from_numpy(re), torch.from_numpy(im), cfg, length)[0].numpy()
    np.testing.assert_allclose(fft_istft(re[0], im[0], cfg, length, chunk=3), want,
                               **ISTFT_TOL)


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
