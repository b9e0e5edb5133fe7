"""The embedder's grouped positional conv on the tensor cores: kernel F's
wrapper, its weight images and its plain version.

The conv is XLS-R's positional embedding (k 128, 16 groups of 120 channels,
padding k // 2, the trailing frame of an even k dropped), taken on the
residual stream's own layout: x [B, T, H] in, y [B, T, H] out, so that
neither side transposes. The weight is torch's grouped Conv1d layout
[H, H / groups, k]. The kernel is `csrc/pos_conv.cu`: bf16 products on the
tensor cores (wgmma) with f32 sums, an implicit GEMM whose operand of every
tap is one tile of input rows read from a shifted row.

Cast points (flax `nn.Conv(dtype=bf16)`, as `models/wav2vec2.py::_conv1d`
takes them): the bias-free sum over k taps x H / groups channels in f32,
rounded to bf16, then the bias added in bf16.

The kernel reads its weights as an image of its shared-memory stages
(`pos_conv_image`): for each group, K = k x cg (tap-major) in steps of 16,
each step wgmma's K-major core matrices of 8 output x 8 input channels (128
contiguous bytes), the step's two 8-channel halves side by side; the output
channels padded with zeros to the kernel's wgmma width (`WIDTH`), the steps
to whole stages of `STAGE_STEPS`. `pos_conv_grad_image` is the image of the
input gradient's conv: for a stride-1 conv the gradient with respect to x
is the same conv over the output's gradient with the taps flipped and the
in and out channels swapped within each group, from pad_left' = k - 1 -
pad_left. A caller keeps both per weight (`ops/quant.py::derived`).

The kernel is two registered ops: `addv::pos_conv` (forward, with bias)
and `addv::pos_conv_dgrad` (the input gradient, no bias). Their CPU
implementation is the plain version on the weight the image holds, their
CUDA implementation the launch, their fake implementation the output's
shape. `_PosConv` carries the gradient: x's through `addv::pos_conv_dgrad`,
the weight's and the bias's (which no use of the system asks for: the
embedder is frozen) in plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xai_audio_deepfakes_tpu_torch.ops import _cuda
from xai_audio_deepfakes_tpu_torch.ops._autograd import needs_grad

STAGE_STEPS = 6  # k16 steps of K in one of the kernel's weight stages
WIDTH = 120  # the kernel's wgmma N: a group's output channels, zero-padded
MAX_TAPS = 128


def supports_pos_conv(kernel_size: int, group_width: int) -> bool:
    """Kernel F takes up to MAX_TAPS taps and a group width that is a
    multiple of 8 up to WIDTH (wgmma's N is the group's channels): XLS-R's
    120, and every narrower wav2vec2 group."""
    return 1 <= kernel_size <= MAX_TAPS and group_width % 8 == 0 and 0 < group_width <= WIDTH


def image_steps(kernel_size: int, group_width: int) -> int:
    """k16 steps of the image per group: K = k x cg in steps of 16, whole
    stages."""
    steps = -(-kernel_size * group_width // 16)
    return -(-steps // STAGE_STEPS) * STAGE_STEPS


def pos_conv_image(weight: torch.Tensor) -> torch.Tensor:
    """[H, cg, k] -> [groups, steps, WIDTH / 8, 2, 8, 8]: element [g, s, nb,
    h, r, j] is weight[g cg + 8 nb + r, kk % cg, kk // cg] with kk = 16 s +
    8 h + j, zero for an output channel past cg or kk past k cg."""
    h, cg, k = weight.shape
    groups, n, steps = h // cg, WIDTH, image_steps(k, cg)
    # [g, co, tap * cg + ci]
    w = weight.detach().reshape(groups, cg, cg, k).permute(0, 1, 3, 2).reshape(groups, cg, k * cg)
    wk = w.new_zeros(groups, n, steps * 16)
    wk[:, :cg, :k * cg] = w
    return wk.reshape(groups, n // 8, 8, steps, 2, 8).permute(0, 3, 1, 4, 2, 5).contiguous()


def weight_from_image(image: torch.Tensor, channels: int, kernel_size: int) -> torch.Tensor:
    """The [H, cg, k] weight an image holds (H = `channels`)."""
    groups, steps, nb = image.shape[:3]
    cg = channels // groups
    wk = image.permute(0, 2, 4, 1, 3, 5).reshape(groups, 8 * nb, steps * 16)
    w = wk[:, :cg, :kernel_size * cg].reshape(groups, cg, kernel_size, cg)
    return w.permute(0, 1, 3, 2).reshape(channels, cg, kernel_size)


def grad_weight(weight: torch.Tensor) -> torch.Tensor:
    """The input gradient's conv weight: taps flipped, in and out channels
    swapped within each group. [H, cg, k] -> [H, cg, k]."""
    h, cg, k = weight.shape
    return weight.reshape(h // cg, cg, cg, k).transpose(1, 2).flip(-1).reshape(h, cg, k)


def pos_conv_grad_image(weight: torch.Tensor) -> torch.Tensor:
    """The image of the input gradient's conv (`grad_weight`)."""
    return pos_conv_image(grad_weight(weight.detach()))


def _right_pad(t: int, t_out: int, k: int, pad_left: int) -> int:
    """Zero frames after x so that the conv gives at least t_out frames."""
    return max(t_out + k - 1 - t - pad_left, 0)


def pos_conv_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                   pad_left: int, t_out: int) -> torch.Tensor:
    """Plain version of kernel F. x [B, T, H], weight [H, cg, k], bias [H]
    or None -> y [B, t_out, H] in x's dtype, y[b, t] reading x's frames
    t - pad_left .. t - pad_left + k - 1 (zero outside). F.conv1d in f32 on
    the operands as they are (bf16 values are exact in f32), the sum rounded
    to x's dtype, then the bias added in that dtype. On a card its f32
    convolution is full f32 only with `torch.backends.cudnn.allow_tf32 =
    False`, which the pipeline sets."""
    h, cg, k = weight.shape
    xt = F.pad(x.float().transpose(1, 2), (pad_left, _right_pad(x.shape[1], t_out, k, pad_left)))
    y = F.conv1d(xt, weight.float(), groups=h // cg)[..., :t_out].to(x.dtype)
    if bias is not None:
        y = y + bias[:, None]
    return y.transpose(1, 2).contiguous()


def pos_conv_weight_grad(x: torch.Tensor, grad: torch.Tensor, weight: torch.Tensor,
                         pad_left: int) -> torch.Tensor:
    """The weight's gradient of `pos_conv_plain` against `grad` [B, t_out,
    H], in f32 from the operands, cast to the weight's dtype."""
    h, cg, k = weight.shape
    t_out = grad.shape[1]
    xt = F.pad(x.float().transpose(1, 2), (pad_left, _right_pad(x.shape[1], t_out, k, pad_left)))
    gt = grad.float().transpose(1, 2)
    gt = F.pad(gt, (0, xt.shape[-1] - k + 1 - t_out))  # frames past t_out had no gradient
    gw = torch.nn.grad.conv1d_weight(xt, weight.shape, gt, groups=h // cg)
    return gw.to(weight.dtype)


@torch.library.custom_op(f"{_cuda.NAMESPACE}::pos_conv", mutates_args=(), device_types="cpu")
def pos_conv_op(x: torch.Tensor, image: torch.Tensor, bias: torch.Tensor | None,
                kernel_size: int, pad_left: int, t_out: int) -> torch.Tensor:
    """Kernel F's forward as a registered op; on the CPU, the plain version."""
    weight = weight_from_image(image, x.shape[-1], kernel_size)
    return pos_conv_plain(x, weight, bias, pad_left, t_out)


@pos_conv_op.register_fake
def _(x, image, bias, kernel_size, pad_left, t_out):
    return x.new_empty((x.shape[0], t_out, x.shape[2]))


@torch.library.custom_op(f"{_cuda.NAMESPACE}::pos_conv_dgrad", mutates_args=(),
                         device_types="cpu")
def pos_conv_dgrad_op(grad: torch.Tensor, image: torch.Tensor, kernel_size: int,
                      pad_left: int) -> torch.Tensor:
    """Kernel F on the gradient image as a registered op: grad [B, T, H]
    (the output's gradient) -> x's gradient [B, T, H], no bias; on the CPU,
    the plain version."""
    weight = weight_from_image(image, grad.shape[-1], kernel_size)
    return pos_conv_plain(grad, weight, None, pad_left, grad.shape[1])


@pos_conv_dgrad_op.register_fake
def _(grad, image, kernel_size, pad_left):
    return torch.empty_like(grad)


def _launch(name: str, x: torch.Tensor, image: torch.Tensor, bias: torch.Tensor | None,
            kernel_size: int, pad_left: int, t_out: int) -> torch.Tensor:
    x = x.contiguous()
    _cuda.require_cuda(name, x, image, dtypes=(torch.bfloat16,))
    if bias is not None:
        _cuda.require_cuda(name, x, bias, dtypes=(torch.bfloat16,))
    if x.ndim != 3:
        raise ValueError(f"{name}: x {tuple(x.shape)} is not [B, T, H]")
    b, t, h = x.shape
    groups = image.shape[0]
    cg = h // groups
    if (h % groups or not supports_pos_conv(kernel_size, cg)
            or tuple(image.shape) != (groups, image_steps(kernel_size, cg), WIDTH // 8, 2, 8, 8)
            or not 0 <= pad_left < kernel_size or t_out < 1
            or (bias is not None and tuple(bias.shape) != (h,))):
        raise ValueError(f"{name}: x {tuple(x.shape)}, image {tuple(image.shape)}, k "
                         f"{kernel_size}, pad_left {pad_left}, t_out {t_out}")
    if x.data_ptr() % 16:  # the kernel copies x in 16-byte pieces
        x = x.clone()
    if image.data_ptr() % 16:  # and the image by bulk copies
        image = image.clone()
    y = torch.empty((b, t_out, h), dtype=x.dtype, device=x.device)
    err = _cuda.library().addv_pos_conv(
        x.data_ptr(), image.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(),
        b, t, t_out, h, groups, kernel_size, pad_left, int(name == "pos_conv_dgrad"),
        _cuda.stream_handle(x),
    )
    _cuda.check(err, name)
    _cuda.LAUNCHES[name] += 1
    return y


@pos_conv_op.register_kernel("cuda")
def _pos_conv_cuda(x: torch.Tensor, image: torch.Tensor, bias: torch.Tensor | None,
                   kernel_size: int, pad_left: int, t_out: int) -> torch.Tensor:
    return _launch("pos_conv", x, image, bias, kernel_size, pad_left, t_out)


@pos_conv_dgrad_op.register_kernel("cuda")
def _pos_conv_dgrad_cuda(grad: torch.Tensor, image: torch.Tensor, kernel_size: int,
                         pad_left: int) -> torch.Tensor:
    return _launch("pos_conv_dgrad", grad, image, None, kernel_size, pad_left, grad.shape[1])


class _PosConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, image, grad_image, pad_left):
        ctx.pad_left = pad_left
        ctx.bias_dtype = None if bias is None else bias.dtype
        # x only for the weight's gradient
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, weight, grad_image)
        return pos_conv_op(x, image, bias, weight.shape[-1], pad_left, x.shape[1])

    @staticmethod
    def backward(ctx, grad):
        x, weight, grad_image = ctx.saved_tensors
        k = weight.shape[-1]
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            if grad_image is None:
                grad_image = pos_conv_grad_image(weight)
            gx = pos_conv_dgrad_op(grad.contiguous(), grad_image, k, k - 1 - ctx.pad_left)
        if ctx.needs_input_grad[1]:
            gw = pos_conv_weight_grad(x, grad, weight, ctx.pad_left)
        if ctx.needs_input_grad[2]:
            gb = grad.float().sum((0, 1)).to(ctx.bias_dtype)
        return gx, gw, gb, None, None, None


def pos_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, pad_left: int,
             image: torch.Tensor | None = None,
             grad_image: torch.Tensor | None = None) -> torch.Tensor:
    """The grouped conv of x [B, T, H] with weight [H, cg, k] (and bias [H]),
    frame t reading frames t - pad_left .. t - pad_left + k - 1 -> [B, T, H].
    CPU tensors take the plain version; CUDA tensors launch kernel F.
    `image` and `grad_image` are the weight's images, built here when not
    given. Carries a gradient to x (kernel F on the gradient image), the
    weight and the bias."""
    if image is None:
        image = pos_conv_image(weight)
    if needs_grad(x, weight, bias):
        return _PosConv.apply(x, weight, bias, image, grad_image, pad_left)
    return pos_conv_op(x, image, bias, weight.shape[-1], pad_left, x.shape[1])
