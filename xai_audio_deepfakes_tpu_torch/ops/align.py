"""Cross-correlation waveform alignment (port of `ops/align.py`): the lag
that maximises the full cross-correlation of a vocoded clip with its
source, found by an FFT product on the device (`torch.fft`, as the JAX
package's `jnp.fft`), then both clips trimmed to their aligned overlap.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from xai_audio_deepfakes_tpu_torch.device import resolve_device


def xcorr_shift(ref: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """Lag in samples (a 0-d int64 tensor on the inputs' device) maximising
    corr(ref, deg): positive means `deg` is delayed relative to `ref`. The
    first maximum wins a tie, as `jnp.argmax`."""
    n = ref.shape[-1] + deg.shape[-1]
    size = 2 ** math.ceil(math.log2(n))
    cc = torch.fft.irfft(torch.fft.rfft(ref, size) * torch.conj(torch.fft.rfft(deg, size)), size)
    # lags -len(deg) .. -1 wrap to the end, then 0 .. len(ref) - 1
    idx = torch.argmax(torch.cat([cc[..., -deg.shape[-1]:], cc[..., : ref.shape[-1]]], dim=-1))
    return idx - deg.shape[-1]


def align_waveforms(ref: np.ndarray, deg: np.ndarray,
                    device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Both clips trimmed to their overlapping, aligned region (host arrays
    in and out; the correlation runs on `device`)."""
    dev = resolve_device(device)
    shift = int(xcorr_shift(torch.as_tensor(ref, dtype=torch.float32, device=dev),
                            torch.as_tensor(deg, dtype=torch.float32, device=dev)))
    if shift > 0:
        ref_a = ref[shift:]
        deg_a = deg[: ref_a.shape[-1]]
    else:
        deg_a = deg[-shift:]
        ref_a = ref[: deg_a.shape[-1]]
    m = min(ref_a.shape[-1], deg_a.shape[-1])
    return ref_a[:m], deg_a[:m]
