"""STFT / iSTFT with torch.stft's conventions: plain PyTorch versions (port of
`ops/stft.py`).

The DFT is two products against precomputed cosine and sine bases, as in the
JAX package, so the plain versions here and the kernels in
`ops/cuda_stft.py` compute the same sums. These functions are the kernels'
plain versions: the CPU runs them, and on the card they are what each kernel
is held against.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from xai_audio_deepfakes_tpu_torch.config import STFTConfig
from xai_audio_deepfakes_tpu_torch.ops.window import torch_style_window


@functools.lru_cache(maxsize=None)
def _dft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Forward one-sided DFT bases [n_fft, n_fft//2+1]: Re = frames @ C,
    Im = frames @ S, with X_k = sum_n x_n e^{-2 pi i n k / N}."""
    k = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    ks = np.arange(k, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * ks / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _fft_twiddles(n_fft: int) -> np.ndarray:
    """Twiddle table of kernel B's FFT body, [n_fft, 2]: (Re, Im) of
    e^{-2 pi i m / n_fft} for m = 0 .. n_fft - 1, made in float64."""
    ang = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return np.stack([np.cos(ang), -np.sin(ang)], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _idft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Inverse bases [n_fft//2+1, n_fft] using the hermitian symmetry of a
    real signal's DFT: x = Re @ A + Im @ B."""
    k = n_fft // 2 + 1
    ks = np.arange(k, dtype=np.float64)[:, None]
    n = np.arange(n_fft, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * ks * n / n_fft
    c = np.full((k, 1), 2.0)
    c[0] = 1.0
    if n_fft % 2 == 0:
        c[-1] = 1.0
    a = (c * np.cos(ang) / n_fft).astype(np.float32)
    b = (-c * np.sin(ang) / n_fft).astype(np.float32)
    return a, b


@functools.lru_cache(maxsize=None)
def _ola_envelope(
    num_frames_: int, n_fft: int, hop: int, window_kind: str, win_length: int
) -> np.ndarray:
    """Sum of squared windows at each output sample (before the trim)."""
    w = torch_style_window(window_kind, win_length, n_fft, dtype=np.float64)
    padded_len = n_fft + hop * (num_frames_ - 1)
    env = np.zeros(padded_len, dtype=np.float64)
    for t in range(num_frames_):
        env[t * hop : t * hop + n_fft] += w * w
    return env.astype(np.float32)


@functools.lru_cache(maxsize=32)
def device_constant(name: str, device: torch.device, *key) -> torch.Tensor:
    """The numpy constants above as f32 tensors on `device`, made once per
    device and shape (the kernels and the plain versions share them). Made
    as normal tensors even under inference_mode, since the cache outlives
    the call."""
    if name == "window":
        arr = torch_style_window(*key)
    elif name == "dft":
        arr = np.stack(_dft_bases(*key))  # [2, n_fft, bins]
    elif name == "twiddle":
        arr = _fft_twiddles(*key)  # [n_fft, 2]
    elif name == "idft":
        arr = np.stack(_idft_bases(*key))  # [2, bins, n_fft]
    elif name == "envelope":
        arr = _ola_envelope(*key)
    else:
        raise KeyError(name)
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def pad_signal(x: torch.Tensor, cfg: STFTConfig) -> torch.Tensor:
    """[B, L] -> [B, L + n_fft] reflect-padded by n_fft//2 on both sides
    (unchanged when cfg.center is off)."""
    if not cfg.center:
        return x
    pad = cfg.n_fft // 2
    return F.pad(x[:, None, :], (pad, pad), mode=cfg.pad_mode)[:, 0, :]


def stft_plain(x: torch.Tensor, cfg: STFTConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel B. [B, L] f32 -> (re, im), each [B, F, T]."""
    if x.ndim == 1:
        x = x[None]
    xp = pad_signal(x, cfg)
    win = device_constant("window", x.device, cfg.window, cfg.win_length, cfg.n_fft)
    frames = xp.unfold(-1, cfg.n_fft, cfg.hop_length) * win  # [B, T, n_fft]
    bases = device_constant("dft", x.device, cfg.n_fft)
    re = torch.matmul(frames, bases[0])
    im = torch.matmul(frames, bases[1])
    return re.transpose(-1, -2).contiguous(), im.transpose(-1, -2).contiguous()


def istft_plain(
    real: torch.Tensor, imag: torch.Tensor, cfg: STFTConfig, length: int
) -> torch.Tensor:
    """Plain version of kernel C. (re, im) [B, F, T] -> [B, length]: inverse
    DFT per frame, window, overlap-add, division by the window-square
    envelope where it exceeds 1e-11, centre trim, crop or zero-pad."""
    if real.ndim == 2:
        real, imag = real[None], imag[None]
    b, _, t = real.shape
    n_fft, hop = cfg.n_fft, cfg.hop_length
    bases = device_constant("idft", real.device, n_fft)
    frames = torch.matmul(real.transpose(-1, -2), bases[0]) + torch.matmul(
        imag.transpose(-1, -2), bases[1]
    )  # [B, T, n_fft]
    win = device_constant("window", real.device, cfg.window, cfg.win_length, n_fft)
    frames = frames * win
    padded_len = n_fft + hop * (t - 1)
    y = F.fold(
        frames.transpose(1, 2),
        output_size=(1, padded_len),
        kernel_size=(1, n_fft),
        stride=(1, hop),
    ).reshape(b, padded_len)
    env = device_constant(
        "envelope", real.device, t, n_fft, hop, cfg.window, cfg.win_length
    )
    y = y / torch.where(env > 1e-11, env, torch.ones_like(env))
    if cfg.center:
        y = y[:, n_fft // 2 :]
    if y.shape[-1] >= length:
        return y[:, :length].contiguous()
    return F.pad(y, (0, length - y.shape[-1]))
