"""Seeded speech-like clips, made on the device (after the port's
`data/synthetic.py::speechlike_clips`): a harmonic stack at a random f0 with
1/k roll-off and a formant-like boost, random phases, a slow amplitude
envelope, peak-normalised, plus a white noise floor, scaled by a gain. The
parameters come from the traffic file's `clips`; the draw from a
`torch.Generator` on the device, so the same seed gives the same clips."""

from __future__ import annotations

import math

import torch

CHUNK = 8  # clips made at once: [CHUNK, harmonics, samples] float64 phases


def speechlike(gen: torch.Generator, n: int, num_samples: int, sample_rate: int,
               p: dict, device) -> torch.Tensor:
    """-> [n, num_samples] f32 on `device`."""
    lo, hi = p["f0_hz"]
    max_harm = int(p["max_harmonic_hz"] // lo)
    t = torch.arange(num_samples, device=device, dtype=torch.float64) / sample_rate
    k = torch.arange(1, max_harm + 1, device=device, dtype=torch.float64)
    out = torch.empty(n, num_samples, device=device)
    for i in range(0, n, CHUNK):
        m = min(CHUNK, n - i)
        u = torch.rand(m, 4, generator=gen, device=device, dtype=torch.float64)
        f0 = lo + (hi - lo) * u[:, 0:1]  # [m, 1]
        phase = torch.rand(m, max_harm, generator=gen, device=device, dtype=torch.float64)
        noise = torch.randn(m, num_samples, generator=gen, device=device)
        fk = k[None, :] * f0  # [m, H]
        live = fk <= p["max_harmonic_hz"]
        amp = (1.0 / k) * (1.0 + 3.0 * torch.exp(-((fk - p["formant_hz"]) ** 2) / 2e5)) * live
        cycles = torch.frac(fk[:, :, None] * t[None, None, :] + phase[:, :, None])
        sig = (amp[:, :, None] * torch.sin(2 * math.pi * cycles)).sum(dim=1)
        elo, ehi = p["envelope_hz"]
        env = 0.55 + 0.45 * torch.sin(2 * math.pi * (elo + (ehi - elo) * u[:, 1:2]) * t[None]
                                      + 2 * math.pi * u[:, 2:3])
        sig = sig * env
        sig = sig / (sig.abs().amax(dim=1, keepdim=True) + 1e-9)
        out[i:i + m] = (p["gain"] * (sig.float() + p["noise"] * noise))
    return out
