"""Fused stride-2 conv1d + channel LayerNorm + GELU for the conv frontend's
layers 1-6: kernel E's wrapper and its plain version (the port's counterpart
of `ops/pallas_conv.py`).

The activation is [B, C, L] on both sides, so layer 0 (conv + kernel D) feeds
it and the feature projection reads it without a transpose. The weight is
torch's Conv1d layout [Cout, Cin, k]. The kernel is `csrc/conv_ln_gelu.cu`:
bf16 products run on the tensor cores (wgmma) with f32 accumulation, fed by a
ring of weight and im2col sample tiles, f32 products as full-f32 FMAs on the
CUDA cores (never TF32). The wrapper hands the bf16 body its weights as the
image of its shared-memory stages (`weight_image`), so that each stage's
weights are one contiguous bulk copy in wgmma's operand layout.

Order of operations (the Pallas kernel body's, which decides the bf16
result): the f32 conv sum is rounded to the compute dtype, the conv bias is
added in f32, the LayerNorm statistics are f32, the normalised value is
rounded to the compute dtype, and GELU is taken in f32 from that value. In
f32 this equals the unfused conv -> LayerNorm -> GELU.

The kernel is the registered op `addv::conv_ln_gelu` (`conv_ln_gelu_op`):
its CPU implementation is the plain version, its CUDA implementation the
launch, with what reads a data pointer (the 16-byte check) and the weight
image inside; its fake implementation gives the output's shape.

The gradient is `_ConvLnGelu`, around the op: the forward launches the
kernel, the backward runs autograd through `conv_ln_gelu_plain` from the
saved inputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xai_audio_deepfakes_tpu_torch.ops import _cuda
from xai_audio_deepfakes_tpu_torch.ops._autograd import needs_grad, recompute_vjp
from xai_audio_deepfakes_tpu_torch.ops.cuda_ln_gelu import ln_gelu_from_f32

STRIDE = 2
BF16_COUTS = (128, 256, 512)  # the Couts the bf16 body is instantiated for


def supports_fused_conv(kernel: int, stride: int, cin: int, cout: int) -> bool:
    """The kernel covers the six 512 -> 512 stride-2 layers of XLS-R's conv
    stack (k 3 four times, k 2 twice). Layer 0 (Cin = 1, k 10, stride 5)
    stays conv + kernel D. The bf16 body is instantiated for Cout 128, 256
    and 512 (wgmma's N is Cout / 2), so other Couts take conv + kernel D."""
    return stride == STRIDE and kernel in (2, 3) and cin % 128 == 0 and cout in BF16_COUTS


CHUNK = 16  # input channels per stage of the bf16 body


def weight_image(weight: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, k] -> the bf16 body's stage image [Cin / 16, k, Cout / 8, 2,
    8, 8]: chunk c, tap, then wgmma's K-major core matrices of 8 output x 8
    input channels (128 contiguous bytes), the two 8-channel halves of input
    channels 16 c .. 16 c + 15 side by side. Element [c, tap, cb, h, r, j]
    is weight[8 cb + r, 16 c + 8 h + j, tap]."""
    cout, cin, k = weight.shape
    w = weight.detach().reshape(cout // 8, 8, cin // CHUNK, 2, 8, k)
    return w.permute(2, 5, 0, 3, 1, 4).contiguous()


def conv_ln_gelu_plain(x, weight, conv_bias, scale, bias, eps: float, gelu: str) -> torch.Tensor:
    """Plain version of kernel E. x [B, Cin, L], weight [Cout, Cin, k],
    conv_bias / scale / bias [Cout] -> [B, Cout, (L - k) // 2 + 1] in x's
    dtype. On a card its f32 convolution is full f32 only with
    `torch.backends.cudnn.allow_tf32 = False`, which the pipeline sets."""
    conv = F.conv1d(x.float(), weight.float(), stride=STRIDE)  # f32 products and sums
    a32 = conv.to(x.dtype).float() + conv_bias.float()[:, None]
    return ln_gelu_from_f32(a32, scale, bias, eps, gelu, x.dtype)


@torch.library.custom_op(f"{_cuda.NAMESPACE}::conv_ln_gelu", mutates_args=(), device_types="cpu")
def conv_ln_gelu_op(x: torch.Tensor, weight: torch.Tensor, conv_bias: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor, eps: float,
                    gelu: str) -> torch.Tensor:
    """Kernel E as a registered op; on the CPU, the plain version."""
    return conv_ln_gelu_plain(x, weight, conv_bias, scale, bias, eps, gelu)


@conv_ln_gelu_op.register_fake
def _(x, weight, conv_bias, scale, bias, eps, gelu):
    length_out = (x.shape[-1] - weight.shape[-1]) // STRIDE + 1
    return x.new_empty((x.shape[0], weight.shape[0], length_out))


@conv_ln_gelu_op.register_kernel("cuda")
def _conv_ln_gelu_cuda(x: torch.Tensor, weight: torch.Tensor, conv_bias: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor, eps: float,
                       gelu: str) -> torch.Tensor:
    x = x.contiguous()
    _cuda.require_cuda("conv_ln_gelu", x, weight, dtypes=tuple(_cuda.DTYPE_CODES))
    _cuda.require_cuda("conv_ln_gelu", x, conv_bias, scale, bias,
                       dtypes=(x.dtype, torch.float32))
    if x.ndim != 3 or weight.ndim != 3 or weight.dtype != x.dtype:
        raise ValueError(f"conv_ln_gelu: x {tuple(x.shape)} {x.dtype}, "
                         f"weight {tuple(weight.shape)} {weight.dtype}")
    b, cin, length = x.shape
    cout, wcin, k = weight.shape
    lib = _cuda.library()
    if (wcin != cin or not supports_fused_conv(k, STRIDE, cin, cout)
            or cout > lib.addv_conv_ln_gelu_max_c() or length < k):
        raise ValueError(f"conv_ln_gelu: x {tuple(x.shape)}, weight {tuple(weight.shape)}")
    for name, t in (("conv_bias", conv_bias), ("scale", scale), ("bias", bias)):
        if t.shape != (cout,):
            raise ValueError(f"conv_ln_gelu: {name} {tuple(t.shape)}, Cout {cout}")
    if x.dtype == torch.bfloat16:
        if x.data_ptr() % 16:  # the bf16 body copies x in 16-byte pieces
            x = x.clone()
        w_t = weight_image(weight)
    else:  # [k, Cin, Cout]: a staged weight row is contiguous over the output channels
        w_t = weight.detach().permute(2, 1, 0).contiguous()
    cb = conv_bias.detach().float()
    out = torch.empty((b, cout, (length - k) // STRIDE + 1), dtype=x.dtype, device=x.device)
    err = lib.addv_conv_ln_gelu(
        x.data_ptr(), w_t.data_ptr(), cb.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, cin, cout, length, k, float(eps),
        int(gelu == "tanh"), _cuda.DTYPE_CODES[x.dtype], _cuda.stream_handle(x),
    )
    _cuda.check(err, "conv_ln_gelu")
    _cuda.LAUNCHES["conv_ln_gelu"] += 1
    return out


class _ConvLnGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, conv_bias, scale, bias, eps, gelu):
        ctx.save_for_backward(x, weight, conv_bias, scale, bias)
        ctx.eps, ctx.gelu = eps, gelu
        return conv_ln_gelu_op(x, weight, conv_bias, scale, bias, eps, gelu)

    @staticmethod
    def backward(ctx, grad):
        eps, gelu = ctx.eps, ctx.gelu
        grads = recompute_vjp(lambda *a: conv_ln_gelu_plain(*a, eps, gelu),
                              ctx.saved_tensors, ctx.needs_input_grad[:5], grad)
        return (*grads, None, None)


def conv_ln_gelu(x: torch.Tensor, weight: torch.Tensor, conv_bias: torch.Tensor | None,
                 scale: torch.Tensor, bias: torch.Tensor, eps: float, gelu: str) -> torch.Tensor:
    """GELU(LN_C(conv1d(x, weight, stride 2) + conv_bias)) for x [B, Cin, L]
    -> [B, Cout, Lout]. scale and bias are the LayerNorm's, [Cout] f32. CPU
    tensors take the plain version; CUDA tensors launch kernel E. Carries a
    gradient to all five tensors."""
    if gelu not in ("exact", "tanh"):
        raise ValueError(f"unknown gelu {gelu!r}")
    if conv_bias is None:
        conv_bias = torch.zeros(weight.shape[0], dtype=torch.float32, device=x.device)
    args = (x, weight, conv_bias, scale, bias)
    if needs_grad(*args):
        return _ConvLnGelu.apply(*args, eps, gelu)
    return conv_ln_gelu_op(*args, eps, gelu)
