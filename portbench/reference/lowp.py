"""Low-precision arithmetic of the reference, written from the stated
formulations alone.

Integer products (`int8`, and `int4` for the control): symmetric scales
s = max(max|x| / qmax, 1e-12) (or, where a configuration says the floor comes
first, max(max|x|, 1e-12) / qmax), codes round(x / s) to nearest even,
clipped to +-qmax; weights per output channel, activations per token (dense
layers) or per sample (convolutions); the integer sums are exact (float64
products of integers) and the result is sum * (s_x * s_w) in float32.

`fp8` stands for the step below bfloat16 in the control: each operand
rounded to float8 e4m3 under a per-row (activations) or per-output-channel
(weights) scale that maps its largest magnitude to 448, then multiplied as
bfloat16 values.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

QMAX = {"int8": 127.0, "int4": 7.0}
_E4M3_MAX = 448.0


def int_scale(x: torch.Tensor, dims, qmax: float, floor_first: bool = False) -> torch.Tensor:
    a = x.float().abs().amax(dim=dims, keepdim=True)
    q = torch.full_like(a, qmax)
    if floor_first:
        return torch.clamp_min(a, 1e-12) / q
    return torch.clamp_min(a / q, 1e-12)


def int_codes(x: torch.Tensor, scale: torch.Tensor, qmax: float) -> torch.Tensor:
    """round(x / scale) clipped to +-qmax, as float64 integers."""
    return torch.clamp(torch.round(x.float() / scale), -qmax, qmax).double()


def int_linear(x: torch.Tensor, w: torch.Tensor, kind: str) -> torch.Tensor:
    """x [..., K] @ w[N, K]^T with per-token activation and per-output-channel
    weight codes of `kind` -> float32 [..., N] (no bias)."""
    qmax = QMAX[kind]
    sx = int_scale(x, -1, qmax)
    sw = int_scale(w, 1, qmax).reshape(-1)
    acc = int_codes(x, sx, qmax) @ int_codes(w, sw[:, None], qmax).T
    return acc.float() * (sx * sw)


def int_grouped_conv1d(x: torch.Tensor, w: torch.Tensor, padding: int, groups: int,
                       kind: str) -> torch.Tensor:
    """x [B, C, L] * w [Cout, C / groups, k], one activation scale per sample
    and one weight scale per output channel, both with the floor first ->
    float32 [B, Cout, L'] (no bias)."""
    qmax = QMAX[kind]
    sx = int_scale(x, (1, 2), qmax, floor_first=True)  # [B, 1, 1]
    sw = int_scale(w, (1, 2), qmax, floor_first=True).reshape(-1)
    acc = F.conv1d(int_codes(x, sx, qmax), int_codes(w, sw[:, None, None], qmax),
                   padding=padding, groups=groups)
    return acc.float() * (sx * sw[:, None])


def fp8_round(x: torch.Tensor, dims) -> torch.Tensor:
    """x rounded to e4m3 under a scale per slice over `dims`, returned as
    bfloat16."""
    x = x.float()
    s = torch.clamp_min(x.abs().amax(dim=dims, keepdim=True), 1e-30) / _E4M3_MAX
    return ((x / s).to(torch.float8_e4m3fn).float() * s).to(torch.bfloat16)
