"""Plain STFT and inverse STFT, as `torch.stft` / `torch.istft` define them,
by `torch.fft` over explicit frames.

The analysis window is `win_length` ones zero-padded, centred, to `n_fft`;
the signal is reflect-padded by n_fft // 2 on each side; the inverse
windows each frame again, overlap-adds, divides by the sum of squared
windows where that exceeds 1e-11, trims n_fft // 2 and crops or zero-pads
to `length`. Everything is float32 (float64 where asked).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def window(kind: str, win_length: int, n_fft: int, device, dtype=torch.float32) -> torch.Tensor:
    """`win_length` ones zero-padded, centred, to `n_fft`: the rectangular
    window, the only one the benchmark's configurations state."""
    if kind != "rect":
        raise ValueError(f"the reference has no {kind!r} window")
    left = (n_fft - win_length) // 2
    out = torch.zeros(n_fft, dtype=torch.float64)
    out[left:left + win_length] = 1.0
    return out.to(device=device, dtype=dtype)


def stft(x: torch.Tensor, stft_cfg: dict) -> torch.Tensor:
    """x [B, L] -> complex spectrum [B, n_fft // 2 + 1, T]."""
    n_fft, hop = stft_cfg["n_fft"], stft_cfg["hop_length"]
    win = window(stft_cfg["window"], stft_cfg["win_length"], n_fft, x.device, x.dtype)
    xp = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = xp.unfold(-1, n_fft, hop) * win  # [B, T, n_fft]
    return torch.fft.rfft(frames, dim=-1).transpose(1, 2)


def istft(spec: torch.Tensor, stft_cfg: dict, length: int) -> torch.Tensor:
    """complex spectrum [B, n_fft // 2 + 1, T] -> waveform [B, length]."""
    n_fft, hop = stft_cfg["n_fft"], stft_cfg["hop_length"]
    b, _, t = spec.shape
    real_dtype = torch.float64 if spec.dtype == torch.complex128 else torch.float32
    win = window(stft_cfg["window"], stft_cfg["win_length"], n_fft, spec.device, real_dtype)
    frames = torch.fft.irfft(spec.transpose(1, 2), n=n_fft, dim=-1) * win  # [B, T, n_fft]
    total = n_fft + hop * (t - 1)
    idx = (torch.arange(t, device=spec.device)[:, None] * hop
           + torch.arange(n_fft, device=spec.device)[None, :]).reshape(-1)
    y = torch.zeros(b, total, dtype=real_dtype, device=spec.device)
    y.index_add_(1, idx, frames.reshape(b, -1))
    env = torch.zeros(total, dtype=torch.float64, device=spec.device)
    env.index_add_(0, idx, (win.double() ** 2).repeat(t))
    env = env.to(real_dtype)
    y = y / torch.where(env > 1e-11, env, torch.ones_like(env))
    y = y[:, n_fft // 2:]
    if y.shape[-1] >= length:
        return y[:, :length]
    return F.pad(y, (0, length - y.shape[-1]))
