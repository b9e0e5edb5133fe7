"""Mask application and complex re-masking (port of `ops/masking.py`).

The UNet works on the (512, 248) crop of the (513, 249) spectrogram;
`crop_spec` and `pad_mask_to_spec` keep that crop explicit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xai_audio_deepfakes_tpu_torch.config import MaskingConvention


def crop_spec(spec: torch.Tensor, freq_bins: int, frames: int) -> torch.Tensor:
    """[..., F, T] -> [..., freq_bins, frames] head crop."""
    f, t = spec.shape[-2], spec.shape[-1]
    if f < freq_bins or t < frames:
        raise ValueError(f"cannot crop {tuple(spec.shape)} to ({freq_bins}, {frames})")
    return spec[..., :freq_bins, :frames]


def pad_mask_to_spec(mask: torch.Tensor, freq_bins: int, frames: int) -> torch.Tensor:
    """Zero-pad a cropped mask back to the full (freq_bins, frames) spec. A
    mask larger than the spec raises (as `jnp.pad` does on a negative pad;
    F.pad would crop it silently): the feature decoder's mask has the
    embedder's frame count, which must not exceed the STFT's."""
    f, t = mask.shape[-2], mask.shape[-1]
    if f > freq_bins or t > frames:
        raise ValueError(f"mask {tuple(mask.shape)} does not fit in the ({freq_bins}, {frames}) "
                         "spectrogram: the embedder's frames do not align with the STFT's")
    return F.pad(mask, (0, frames - t, 0, freq_bins - f))


def apply_mask(
    mask: torch.Tensor,
    magnitude: torch.Tensor,
    convention: MaskingConvention = MaskingConvention.LINEAR,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (relevant_mag, irrelevant_mag), both shaped like `magnitude`."""
    if MaskingConvention(convention) is MaskingConvention.LINEAR:
        return mask * magnitude, (1.0 - mask) * magnitude
    log_mag = torch.log1p(magnitude)
    return torch.expm1(mask * log_mag), torch.expm1((1.0 - mask) * log_mag)


def remask_complex(
    masked_magnitude: torch.Tensor, phase: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mag, phase) -> (real, imag) = mag * e^{j phase}, as a real pair."""
    return masked_magnitude * torch.cos(phase), masked_magnitude * torch.sin(phase)
