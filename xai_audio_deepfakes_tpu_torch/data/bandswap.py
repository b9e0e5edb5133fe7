"""Band-splice ("any-band") manipulated audio (port of `data/bandswap.py`).

The reference's detector-training protocol: for a real clip and its vocoded
twin, each 1 kHz band of the twin's complex STFT replaces the same band of
the real clip's, and the inverse STFT of each splice is a manipulated
sample (label 1); the untouched real clip is label 0. Out-of-band leakage
above 1e-6 is reported.

Each clip's STFT is kernel B (one launch for the real clip, one for the
twin) and all 8 band variants invert in one launch of kernel C; the band
masks are a [n_bands, F] 0/1 matrix broadcast over the spectra.
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable

import numpy as np
import torch

from xai_audio_deepfakes_tpu_torch.config import STFTConfig
from xai_audio_deepfakes_tpu_torch.device import resolve_device
from xai_audio_deepfakes_tpu_torch.ops.cuda_stft import istft, stft


@functools.lru_cache(maxsize=None)
def band_masks(num_bins: int, sample_rate: int, band_width: float, f_max: float) -> np.ndarray:
    """[n_bands, num_bins] 0/1 masks of the [start, start + band) Hz bands,
    bins at linspace(0, sr / 2, F)."""
    freqs = np.linspace(0, sample_rate / 2, num_bins)
    starts = np.arange(0, f_max, band_width)
    return (
        (freqs[None, :] >= starts[:, None]) & (freqs[None, :] < starts[:, None] + band_width)
    ).astype(np.float32)


def band_spliced_waveforms(
    wav_real: torch.Tensor,
    wav_vocoded: torch.Tensor,
    stft_cfg: STFTConfig = STFTConfig(),
    band_width: float = 1000.0,
    f_max: float = 8000.0,
    length: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """[L] x2 -> (waves [n_bands, L], leakage [n_bands]) on the inputs'
    device.

    waves[i] = istft(the real spectrum with band i replaced by the twin's),
    magnitude and phase; leakage[i] = mean (|combined| - |real|)^2 outside
    band i.
    """
    if length is None:
        length = int(wav_real.shape[-1])
    re_r, im_r = stft(wav_real[None], stft_cfg)
    re_v, im_v = stft(wav_vocoded[None], stft_cfg)
    masks = torch.from_numpy(
        band_masks(stft_cfg.num_bins, stft_cfg.sample_rate, band_width, f_max)
    ).to(wav_real.device)[None, :, :, None]  # [1, n_bands, F, 1]

    def splice(a, b):
        return a[:, None] * (1 - masks) + b[:, None] * masks  # [1, n_bands, F, T]

    re_c = splice(re_r, re_v)[0]
    im_c = splice(im_r, im_v)[0]
    waves = istft(re_c.contiguous(), im_c.contiguous(), stft_cfg, length=length)

    mag_c = torch.sqrt(re_c**2 + im_c**2)
    mag_r = torch.sqrt(re_r**2 + im_r**2)
    out_of_band = 1.0 - masks[0, :, :, 0]  # [n_bands, F]
    diff2 = (mag_c - mag_r) ** 2 * out_of_band[:, :, None]
    leakage = diff2.sum(dim=(1, 2)) / (out_of_band.sum(dim=1) * mag_r.shape[-1])
    return waves, leakage


@torch.inference_mode()
def generate_band_swap_features(
    pairs: Iterable[tuple[np.ndarray, np.ndarray]],
    embed_fn: Callable[[torch.Tensor], torch.Tensor],
    stft_cfg: STFTConfig = STFTConfig(),
    band_width: float = 1000.0,
    f_max: float = 8000.0,
    leakage_warn: float = 1e-6,
    log_fn: Callable[[dict], None] | None = None,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Per (real, vocoded) pair of host arrays: the real clip's mean-pooled
    embedding (label 0) and each band splice's (label 1) -> (X [N, D] f32,
    y [N] int64). `embed_fn` maps [B, L] on `device` to [B, D]; it sees the
    real clip at batch 1 and the splices at batch n_bands, as in the JAX
    package. A pair whose leakage exceeds `leakage_warn` is logged."""
    dev = resolve_device(device)
    xs, ys = [], []
    for wav_real, wav_vocoded in pairs:
        wav_real = torch.as_tensor(wav_real, dtype=torch.float32, device=dev)
        wav_vocoded = torch.as_tensor(wav_vocoded, dtype=torch.float32, device=dev)
        xs.append(embed_fn(wav_real[None])[0].float().cpu().numpy())
        ys.append(0)
        waves, leakage = band_spliced_waveforms(wav_real, wav_vocoded, stft_cfg, band_width,
                                                f_max)
        leak = leakage.cpu().numpy()
        if log_fn is not None and np.any(leak > leakage_warn):
            log_fn({"warning": "band-splice leakage", "max_leakage": float(leak.max())})
        feats = embed_fn(waves).float().cpu().numpy()
        xs.extend(list(feats))
        ys.extend([1] * feats.shape[0])
    return np.stack(xs), np.asarray(ys, dtype=np.int64)
