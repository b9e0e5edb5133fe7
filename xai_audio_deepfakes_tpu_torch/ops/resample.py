"""Sample-rate conversion (port of `ops/resample.py`): Hann-windowed sinc
polyphase resampling, torchaudio's `sinc_interp_hann` method (lowpass filter
width 6, rolloff 0.99).

Host path: numpy (`resample_poly_np`, a copy of the JAX package's, bit for
bit). Device path: the same kernel bank as a strided product in torch
(`resample_torch`), for resampling batches already on the card.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _sinc_kernels(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                  rolloff: float = 0.99) -> tuple[np.ndarray, int]:
    """-> (kernels [new_freq_g, width], orig_freq_g) for the reduced fraction.

    Kernel bank construction mirrors torchaudio's _get_sinc_resample_kernel
    (Hann-windowed sinc at each output phase).
    """
    g = math.gcd(orig_freq, new_freq)
    orig = orig_freq // g
    new = new_freq // g
    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx
    t = t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    scale = base_freq / orig
    kernels = np.where(t == 0, 1.0, np.sinc(t)) * window * scale
    return kernels.astype(np.float32), orig


def resample_poly_np(wav: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """1-D float32 resample (host, numpy)."""
    if orig_freq == new_freq:
        return np.asarray(wav, dtype=np.float32)
    g = math.gcd(int(orig_freq), int(new_freq))
    orig, new = int(orig_freq) // g, int(new_freq) // g
    kernels, _ = _sinc_kernels(int(orig_freq), int(new_freq))
    width = (kernels.shape[1] - orig) // 2
    length = wav.shape[-1]
    x = np.pad(np.asarray(wav, dtype=np.float32), (width, width + orig))
    num_blocks = length // orig + 1
    # frames [num_blocks, kernel_width] strided over hops of `orig`
    strides = (x.strides[-1] * orig, x.strides[-1])
    frames = np.lib.stride_tricks.as_strided(
        x, shape=(num_blocks, kernels.shape[1]), strides=strides
    )
    out = frames @ kernels.T  # [num_blocks, new]
    target_len = int(math.ceil(new_freq * length / orig_freq))
    return out.reshape(-1)[:target_len].astype(np.float32)


def resample_torch(wav: torch.Tensor, orig_freq: int, new_freq: int) -> torch.Tensor:
    """Batched resample on wav's device, [B, L] f32 -> [B, L']: frames of
    the padded signal at hops of the reduced `orig` against the kernel bank."""
    if orig_freq == new_freq:
        return wav
    kernels, orig = _sinc_kernels(int(orig_freq), int(new_freq))
    width = (kernels.shape[1] - orig) // 2
    length = wav.shape[-1]
    x = torch.nn.functional.pad(wav, (width, width + orig))
    frames = x.unfold(-1, kernels.shape[1], orig)  # [B, length // orig + 1, W]
    out = frames @ torch.from_numpy(kernels).to(wav.device).T  # [B, nb, new]
    target_len = int(math.ceil(new_freq * length / orig_freq))
    return out.reshape(wav.shape[0], -1)[:, :target_len]
