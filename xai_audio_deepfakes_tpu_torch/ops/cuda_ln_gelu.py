"""Channel LayerNorm + GELU epilogue of the conv frontend: kernel D's wrapper
and its plain version (the port's counterpart of `ops/pallas_ln_gelu.py`).

The activation is [B, C, L], the layout F.conv1d produces and consumes, so
the frontend never transposes it; statistics run over C for each (b, l).
`ln_gelu_` writes in place, into x's buffer, as the Pallas kernel aliases its
output to its input when the dtypes match. `ln_gelu` is what the embedder
calls: in place when no gradient is recorded (serving keeps its memory), and
out of place through `_LnGelu` when one is, because the backward recomputes
from the input the in-place launch would have overwritten. The kernel is
`csrc/ln_gelu.cu`; it takes any contiguous x, a view with a storage offset
(a data pointer that is not 16-byte aligned) included, and writes at x's
residue modulo 16 bytes: `_empty_at_residue` places a fresh output there.

The kernel is two registered ops over one launch: `addv::ln_gelu`
(`ln_gelu_op`) allocates its output, `addv::ln_gelu_` (`ln_gelu_inplace_op`)
declares x mutated and writes into it. Their CPU implementations are the
plain version, their CUDA implementations the launch, with everything that
reads a data pointer (the residue, `_empty_at_residue`) inside; the fake
implementations give the output's shape. `torch.export` takes the in-place
op as a functional node that writes into a copy of x.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xai_audio_deepfakes_tpu_torch.ops import _cuda
from xai_audio_deepfakes_tpu_torch.ops._autograd import needs_grad, recompute_vjp


def supports_ln_gelu(c: int) -> bool:
    """Where the JAX package takes its LN+GELU kernel
    (`ops/pallas_ln_gelu.py::supports_ln_gelu`): a lane-aligned channel
    count. The embedder takes kernel D's cast points exactly there."""
    return c % 128 == 0


def channel_layer_norm(a32, scale, bias, eps: float) -> torch.Tensor:
    """[B, C, L] f32 -> LayerNorm over C in f32, as `_LNf32Stats` computes it
    before its cast: f32 mean, centred f32 variance, rsqrt(var + eps), f32
    scale and bias."""
    mu = a32.mean(dim=1, keepdim=True)
    xc = a32 - mu
    var = (xc * xc).mean(dim=1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * scale.float()[:, None] + bias.float()[:, None]


def ln_gelu_from_f32(a32, scale, bias, eps: float, gelu: str, dtype) -> torch.Tensor:
    """[B, C, L] f32 -> GELU(LN_C(a32)) in `dtype`, with the kernels' cast
    points: `channel_layer_norm`, cast to `dtype`, then GELU in f32 from that
    value, cast back."""
    normed = channel_layer_norm(a32, scale, bias, eps).to(dtype).float()
    return F.gelu(normed, approximate="tanh" if gelu == "tanh" else "none").to(dtype)


def ln_gelu_plain(x, scale, bias, eps: float, gelu: str) -> torch.Tensor:
    """Plain version of kernel D (returns a new tensor)."""
    return ln_gelu_from_f32(x.float(), scale, bias, eps, gelu, x.dtype)


def _launch(x: torch.Tensor, out: torch.Tensor, scale, bias, eps: float, gelu: str) -> torch.Tensor:
    """Kernel D from x into out (which may be x)."""
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
    if out.data_ptr() % 16 != x.data_ptr() % 16:
        raise ValueError("ln_gelu: out must have x's address modulo 16 bytes "
                         "(the kernel reads and writes each row at one shift)")
    err = lib.addv_ln_gelu(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), b, c, length,
        float(eps), int(gelu == "tanh"), _cuda.DTYPE_CODES[x.dtype], _cuda.stream_handle(x),
    )
    _cuda.check(err, "ln_gelu")
    _cuda.LAUNCHES["ln_gelu"] += 1
    return out


def _empty_at_residue(x: torch.Tensor) -> torch.Tensor:
    """A new contiguous tensor like x whose data pointer has x's residue
    modulo 16 bytes (x may be a view with a storage offset)."""
    off = x.data_ptr() % 16 // x.element_size()
    if off == 0:
        return torch.empty_like(x)
    return torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)[off:].view(x.shape)


def _check_gelu(gelu: str) -> None:
    if gelu not in ("exact", "tanh"):
        raise ValueError(f"unknown gelu {gelu!r}")


@torch.library.custom_op(f"{_cuda.NAMESPACE}::ln_gelu", mutates_args=(), device_types="cpu")
def ln_gelu_op(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
               gelu: str) -> torch.Tensor:
    """Kernel D into a new tensor, as a registered op; on the CPU, the plain
    version."""
    return ln_gelu_plain(x, scale, bias, eps, gelu)


@ln_gelu_op.register_fake
def _(x, scale, bias, eps, gelu):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@ln_gelu_op.register_kernel("cuda")
def _ln_gelu_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
                  gelu: str) -> torch.Tensor:
    x = x.contiguous()
    return _launch(x, _empty_at_residue(x), scale, bias, eps, gelu)


@torch.library.custom_op(f"{_cuda.NAMESPACE}::ln_gelu_", mutates_args=("x",), device_types="cpu")
def ln_gelu_inplace_op(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
                       gelu: str) -> None:
    """Kernel D in place, x <- GELU(LN_C(x)), as a registered op; on the CPU,
    the plain version copied into x."""
    x.copy_(ln_gelu_plain(x, scale, bias, eps, gelu))


@ln_gelu_inplace_op.register_fake
def _(x, scale, bias, eps, gelu):
    return None


@ln_gelu_inplace_op.register_kernel("cuda")
def _ln_gelu_inplace_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
                          gelu: str) -> None:
    _launch(x, x, scale, bias, eps, gelu)


def ln_gelu_(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float, gelu: str) -> torch.Tensor:
    """In place: x [B, C, L] <- GELU(LN_C(x)); returns x. scale and bias are
    [C] f32. CPU tensors take the plain version; CUDA tensors launch kernel D."""
    _check_gelu(gelu)
    ln_gelu_inplace_op(x, scale, bias, eps, gelu)
    return x


class _LnGelu(torch.autograd.Function):
    """Forward: `ln_gelu_op`, kernel D into a fresh tensor (the plain version
    on the CPU).
    Backward: autograd through `ln_gelu_plain` from the saved input."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, gelu):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps, ctx.gelu = eps, gelu
        return ln_gelu_op(x, scale, bias, eps, gelu)

    @staticmethod
    def backward(ctx, grad):
        eps, gelu = ctx.eps, ctx.gelu
        grads = recompute_vjp(lambda x, g, b: ln_gelu_plain(x, g, b, eps, gelu),
                              ctx.saved_tensors, ctx.needs_input_grad[:3], grad)
        return (*grads, None, None)


def ln_gelu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float, gelu: str) -> torch.Tensor:
    """GELU(LN_C(x)) for x [B, C, L]. x is overwritten and returned when no
    gradient is recorded; otherwise the result is a new tensor with a
    gradient to x, scale and bias."""
    _check_gelu(gelu)
    if needs_grad(x, scale, bias):
        return _LnGelu.apply(x, scale, bias, eps, gelu)
    return ln_gelu_(x, scale, bias, eps, gelu)
