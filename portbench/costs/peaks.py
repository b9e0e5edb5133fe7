"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full power limit of 700 W): a share of a peak is stated against
these, with the card's power limit printed beside it."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {
    "bfloat16": 989e12,
    "float32": 67e12,   # outside the tensor cores: the port runs f32 with TF32 off
    "int8": 1979e12,
}
L2_BYTES = 50 * 2**20
POWER_LIMIT_W = 700.0


def bound_s(nbytes: float, ops_by_dtype: dict) -> tuple[float, str]:
    """The least time a call can take: the larger of its bytes over the
    memory rate and its operations over the peak rate of their type
    (summed over types) -> (seconds, "bytes" | "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(ops / PEAK_OPS_PER_S[dt] for dt, ops in ops_by_dtype.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
