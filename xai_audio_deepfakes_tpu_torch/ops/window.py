"""Analysis window as torch.stft applies it: a length-`win_length` window
zero-padded, centred, to `n_fft` (port of `ops/window.py`)."""

from __future__ import annotations

import numpy as np


def periodic_hann(win_length: int) -> np.ndarray:
    """torch.hann_window(win_length) default: periodic Hann."""
    n = np.arange(win_length)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(np.float64)


def torch_style_window(
    kind: str, win_length: int, n_fft: int, dtype=np.float32
) -> np.ndarray:
    """Length-n_fft window; left pad = (n_fft - win_length) // 2. For rect 644
    in 1024: zeros[0:190], ones[190:834], zeros[834:1024]."""
    if kind == "rect":
        w = np.ones(win_length, dtype=np.float64)
    elif kind == "hann":
        w = periodic_hann(win_length)
    else:
        raise ValueError(f"unknown window kind: {kind!r}")
    if win_length > n_fft:
        raise ValueError("win_length must be <= n_fft")
    left = (n_fft - win_length) // 2
    padded = np.zeros(n_fft, dtype=np.float64)
    padded[left : left + win_length] = w
    return padded.astype(dtype)
