"""Channel LayerNorm + GELU epilogue of the conv frontend: kernel D's wrapper
and its plain version (the port's counterpart of `ops/pallas_ln_gelu.py`).

The activation is [B, C, L], the layout F.conv1d produces and consumes, so
the frontend never transposes it; statistics run over C for each (b, l).
The result is written in place, into x's buffer, as the Pallas kernel
aliases its output to its input when the dtypes match. The kernel is
`csrc/ln_gelu.cu`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xai_audio_deepfakes_tpu_torch.ops import _cuda


def ln_gelu_plain(x, scale, bias, eps: float, gelu: str) -> torch.Tensor:
    """Plain version of kernel D (returns a new tensor): f32 mean, centred
    f32 variance, rsqrt(var + eps), f32 scale and bias, cast to x's dtype,
    then GELU in f32 from that value, cast back."""
    x32 = x.float()
    mu = x32.mean(dim=1, keepdim=True)
    xc = x32 - mu
    var = (xc * xc).mean(dim=1, keepdim=True)
    normed = xc * torch.rsqrt(var + eps) * scale.float()[:, None] + bias.float()[:, None]
    normed = normed.to(x.dtype).float()
    return F.gelu(normed, approximate="tanh" if gelu == "tanh" else "none").to(x.dtype)


def ln_gelu_(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float, gelu: str) -> torch.Tensor:
    """In place: x [B, C, L] <- GELU(LN_C(x)); returns x. scale and bias are
    [C] f32. CPU tensors take the plain version; CUDA tensors launch kernel D."""
    if gelu not in ("exact", "tanh"):
        raise ValueError(f"unknown gelu {gelu!r}")
    if x.device.type == "cpu":
        return x.copy_(ln_gelu_plain(x, scale, bias, eps, gelu))
    _cuda.require_cuda("ln_gelu", x, dtypes=tuple(_cuda.DTYPE_CODES))
    _cuda.require_cuda("ln_gelu", scale, bias)
    if x.ndim != 3:
        raise ValueError(f"ln_gelu: x must be [B, C, L], got {tuple(x.shape)}")
    b, c, length = x.shape
    lib = _cuda.library()
    # the kernel keeps a frame's C / 8 values per thread in registers
    if c > lib.addv_ln_gelu_max_c() or scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"ln_gelu: C={c}, scale {tuple(scale.shape)}, bias {tuple(bias.shape)}")
    if scale.device != x.device:
        raise ValueError("ln_gelu: scale and bias must be on x's device")
    err = lib.addv_ln_gelu(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), x.data_ptr(), b, c, length,
        float(eps), int(gelu == "tanh"), _cuda.DTYPE_CODES[x.dtype], _cuda.stream_handle(x),
    )
    _cuda.check(err, "ln_gelu")
    _cuda.LAUNCHES["ln_gelu"] += 1
    return x
