"""Mel spectrogram frontend of the HiFi-GAN vocoder path (port of
`ops/mel.py`).

hop 256, win 1024 periodic Hann, 80 mels, f_max 8 kHz, power 1 (the
magnitude), a slaney-scale, slaney-normalised filterbank (torchaudio
`mel_scale="slaney"`, `norm="slaney"`), then the dynamic-range compression
log(clamp(x, 1e-5)).

The STFT is `ops/cuda_stft.py::stft` (kernel B on the card: 513 x 313 bins
and frames for an 80000-sample clip); the magnitude, the [B, T, 513] @
[513, n_mels] filterbank product (full f32 as the JAX package's
`Precision.HIGHEST`: TF32 is off by PyTorch's default, and the pipeline
sets it off) and the log are PyTorch calls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from xai_audio_deepfakes_tpu_torch.config import MelConfig, STFTConfig
from xai_audio_deepfakes_tpu_torch.ops.cuda_stft import stft


def _hz_to_mel_slaney(hz: np.ndarray) -> np.ndarray:
    hz = np.asarray(hz, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (hz - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        hz >= min_log_hz, min_log_mel + np.log(np.maximum(hz, 1e-10) / min_log_hz) / logstep, mels
    )


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    hz = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), hz)


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    sample_rate: int, n_fft: int, n_mels: int, f_min: float, f_max: float
) -> np.ndarray:
    """Slaney-scale, slaney-normalised triangular filterbank [n_freqs, n_mels]
    f32 (librosa `mel(htk=False, norm='slaney')` / torchaudio slaney/slaney)."""
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sample_rate / 2, n_freqs)
    m_min = _hz_to_mel_slaney(np.array(f_min))
    m_max = _hz_to_mel_slaney(np.array(f_max))
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = _mel_to_hz_slaney(m_pts)  # [n_mels + 2]

    f_diff = np.diff(f_pts)  # [n_mels + 1]
    slopes = f_pts[None, :] - all_freqs[:, None]  # [n_freqs, n_mels + 2]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))  # [n_freqs, n_mels]

    # slaney norm: each filter scaled to about constant energy per channel
    enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
    fb = fb * enorm[None, :]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _filterbank_on(device: torch.device, *key) -> torch.Tensor:
    with torch.inference_mode(False):  # the cache outlives the call
        return torch.from_numpy(mel_filterbank(*key)).to(device)


def mel_stft_config(cfg: MelConfig) -> STFTConfig:
    """The STFT of the mel frontend: Hann window, centred, reflect pad."""
    return STFTConfig(sample_rate=cfg.sample_rate, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                      win_length=cfg.win_length, window="hann", center=True,
                      pad_mode="reflect")


def mel_spectrogram(x: torch.Tensor, cfg: MelConfig,
                    compression: bool | None = None) -> torch.Tensor:
    """[B, L] (or [L]) f32 waveform -> log-mel [B, n_mels, T] f32.

    The power-1 magnitude -> the slaney filterbank -> log(clamp(., clip))
    with `compression` (default from cfg)."""
    re, im = stft(x, mel_stft_config(cfg))  # [B, F, T]
    mag = torch.sqrt(re * re + im * im)
    if cfg.power != 1.0:
        mag = mag**cfg.power
    fb = _filterbank_on(mag.device, cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.f_min, cfg.f_max)
    mel = torch.matmul(mag.transpose(-1, -2), fb).transpose(-1, -2)  # [B, M, T]
    if cfg.compression if compression is None else compression:
        mel = torch.log(torch.clamp(mel, min=cfg.compression_clip))
    return mel
