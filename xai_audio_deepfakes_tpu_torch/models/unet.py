"""Spectrogram-magnitude -> sigmoid-mask UNet decoder (port of
`models/unet.py::UNetMaskDecoder`), NCHW.

Submodules carry the names of the reference's state dict (`e1.block.0/1/3/4`,
`bottleneck.0/1/3/4`, `up1..4`, `mask_head.0`), so a reference `.pth` loads
with `load_state_dict` once a DDP `module.` prefix is stripped
(`load_reference_state_dict`). Encoder channels 1 -> c -> 2c -> 4c -> 8c,
a dilated 16c bottleneck (d=2, then d=4), transposed-conv decoder with skip
concats, 1x1 conv and a sigmoid. BatchNorm uses eps 1e-5 and, for training,
momentum 0.01 (flax's 0.99 in torch's convention); in training mode
(`model.train()`) it normalises with flax's batch statistics, over every
rank's batch under a data axis, and updates the running ones as flax's
`nn.BatchNorm` does (`BatchNorm2d` below).

Cast points (`models/unet.py` of the JAX package), with `UNetConfig.dtype`
as the compute dtype: each conv and transposed conv rounds its bias-free
product to that dtype and adds the bias in it; BatchNorm and the leaky ReLU
run in f32; every skip is cast to the compute dtype before its concat; the
mask head is a conv in the compute dtype, the sigmoid f32. With
`UNetConfig.quant="int8"` the ConvBlock and bottleneck convs are int8
products (`ops/quant.py::int8_conv2d`: per-sample activation scales,
per-output-channel weight scales), the f32 bias added, cast to the compute
dtype; the transposed convs and the mask head stay float. In training mode
(`model.train()`) every conv takes the float path, as the JAX decoder
ignores `quant` when `train` is set.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from xai_audio_deepfakes_tpu_torch.config import UNetConfig
from xai_audio_deepfakes_tpu_torch.device import torch_dtype
from xai_audio_deepfakes_tpu_torch.models.init import lecun_normal_
from xai_audio_deepfakes_tpu_torch.ops.quant import derived, int8_conv2d, quantize_weight
from xai_audio_deepfakes_tpu_torch.parallel.mesh import all_reduce_sum

_BN = dict(eps=1e-5, momentum=0.01)


class BatchNorm2d(nn.BatchNorm2d):
    """flax's `nn.BatchNorm` (f32, `use_fast_variance`, the default).

    In training mode (`model.train()`) it takes, per channel, the sums of x
    and of x^2 and the count n over its batch and, when `group` is a process
    group of more than one rank, all-reduces the three
    (`parallel/mesh.py::all_reduce_sum`), so that every rank normalises with
    the statistics of the whole batch, as flax's do under a data axis. Then
    mean = sum x / n, var = max(sum x^2 / n - mean^2, 0), both cast to f32,
    and y = (x - mean) * (rsqrt(var + eps) * weight) + bias, by plain
    autograd ops. The sums accumulate in f64 over f32 x and x^2, and the
    subtraction runs in f64: in f32, E[x^2] - E[x]^2 loses the digits that
    |mean| / std cancels, and those rounding errors, different in every
    framework's summation order, grew through training into a deviation
    from the JAX package's steps that the f32 centred variance did not
    have; the f32 squares' own rounding (2^-24 relative) is far below that
    cancellation. No f64 tensor is kept for the backward pass: it saves the
    f32 x. The running statistics move by flax's momentum (0.99 kept, torch's
    `momentum` 0.01 taken), the variance biased, as flax keeps it. Without a
    group, or with one of one rank, it is the same code. In eval mode it
    normalises with the running statistics (`F.batch_norm`)."""

    group = None  # the data axis's process group, set by the mesh trainer

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()  # flax nn.BatchNorm(dtype=f32)
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        dims, f64 = (0, 2, 3), torch.float64
        n = torch.full_like(x[0, :, 0, 0], x.numel() // x.shape[1], dtype=f64)
        sums = all_reduce_sum(torch.stack([x.sum(dim=dims, dtype=f64),
                                           (x * x).sum(dim=dims, dtype=f64), n]), self.group)
        mean = sums[0] / sums[2]
        var = torch.clamp_min(sums[1] / sums[2] - mean * mean, 0.0).float()
        mean = mean.float()
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(self.running_mean * (1.0 - m) + mean * m)
            self.running_var.copy_(self.running_var * (1.0 - m) + var * m)
            self.num_batches_tracked += 1
        return y


def set_batch_stats_group(model: nn.Module, group) -> None:
    """Every `BatchNorm2d` of `model` takes its training statistics over
    `group` (None: its own batch)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.group = group


class Conv2d(nn.Conv2d):
    """nn.Conv2d with the JAX `Conv2D`'s cast points: the bias-free product in
    `compute` (a dtype), then the bias in that dtype; or, with `quant` and
    outside training mode, `int8_conv2d` plus the f32 bias, cast to
    `compute`. The f32 parameters are cast at use, as flax does."""

    def __init__(self, *args, compute=torch.float32, quant: bool = False, **kw):
        super().__init__(*args, **kw)
        self.compute, self.quant = compute, quant

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant and not self.training:
            y = int8_conv2d(x, self.weight, self.stride, self.padding, self.dilation,
                            quantized=derived(self, "wq", quantize_weight, self.weight))
            return (y + self.bias).to(self.compute).permute(0, 3, 1, 2)
        y = F.conv2d(x.to(self.compute), self.weight.to(self.compute), None, self.stride,
                     self.padding, self.dilation)
        return y + self.bias.to(self.compute)[:, None, None]


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d with flax `nn.ConvTranspose(dtype=compute)`'s cast
    points: the bias-free product in `compute`, then the bias in it."""

    def __init__(self, *args, compute=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute = compute

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.to(self.compute), self.weight.to(self.compute), None,
                               self.stride)
        return y + self.bias.to(self.compute)[:, None, None]


class ConvBlock(nn.Module):
    """conv(k, s, p) -> BN -> LeakyReLU -> conv(3, 1, 1) -> BN -> LeakyReLU."""

    def __init__(self, cin, cout, kernel=(3, 3), stride=(1, 1), padding=(1, 1), slope=0.2,
                 compute=torch.float32, quant: bool = False):
        super().__init__()
        self.block = nn.Sequential(
            Conv2d(cin, cout, kernel, stride, padding, compute=compute, quant=quant),
            BatchNorm2d(cout, **_BN),
            nn.LeakyReLU(slope),
            Conv2d(cout, cout, 3, 1, 1, compute=compute, quant=quant),
            BatchNorm2d(cout, **_BN),
            nn.LeakyReLU(slope),
        )

    def forward(self, x):
        return self.block(x)


class UNetMaskDecoder(nn.Module):
    """magnitude [B, F, T] (cropped, (512, 248) by default) -> mask [B, F, T]
    in (0, 1), f32."""

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        c, s = cfg.base_channels, cfg.leaky_slope
        dt = self.compute = torch_dtype(cfg.dtype)
        kw = dict(compute=dt, quant=cfg.quant == "int8")
        self.e1 = ConvBlock(1, c, (5, 3), (2, 1), (2, 1), s, **kw)
        self.e2 = ConvBlock(c, 2 * c, (5, 3), (2, 1), (2, 1), s, **kw)
        self.e3 = ConvBlock(2 * c, 4 * c, (3, 3), (2, 2), (1, 1), s, **kw)
        self.e4 = ConvBlock(4 * c, 8 * c, (3, 3), (2, 2), (1, 1), s, **kw)
        self.bottleneck = nn.Sequential(
            Conv2d(8 * c, 16 * c, 3, padding=2, dilation=2, **kw),
            BatchNorm2d(16 * c, **_BN),
            nn.LeakyReLU(s),
            Conv2d(16 * c, 16 * c, 3, padding=4, dilation=4, **kw),
            BatchNorm2d(16 * c, **_BN),
            nn.LeakyReLU(s),
        )
        self.up4 = ConvTranspose2d(16 * c, 8 * c, 2, stride=2, compute=dt)
        self.d4 = ConvBlock(8 * c + 4 * c, 8 * c, slope=s, **kw)
        self.up3 = ConvTranspose2d(8 * c, 4 * c, 2, stride=2, compute=dt)
        self.d3 = ConvBlock(4 * c + 2 * c, 4 * c, slope=s, **kw)
        self.up2 = ConvTranspose2d(4 * c, 2 * c, (2, 1), stride=(2, 1), compute=dt)
        self.d2 = ConvBlock(2 * c + c, 2 * c, slope=s, **kw)
        self.up1 = ConvTranspose2d(2 * c, c, (2, 1), stride=(2, 1), compute=dt)
        self.d1 = ConvBlock(c + 1, c, slope=s, **kw)
        self.mask_head = nn.Sequential(Conv2d(c, 1, 1, compute=dt))

    def forward(self, mag: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.compute
        if tuple(mag.shape[-2:]) != (cfg.freq_bins, cfg.frames):
            raise ValueError(f"UNet takes [B, {cfg.freq_bins}, {cfg.frames}], got {tuple(mag.shape)}")
        x = mag[:, None].to(dt)
        x1 = self.e1(x)
        x2 = self.e2(x1)
        x3 = self.e3(x2)
        x4 = self.e4(x3)
        y = self.bottleneck(x4)
        y = self.d4(torch.cat([self.up4(y), x3.to(dt)], dim=1))
        y = self.d3(torch.cat([self.up3(y), x2.to(dt)], dim=1))
        y = self.d2(torch.cat([self.up2(y), x1.to(dt)], dim=1))
        y = self.d1(torch.cat([self.up1(y), x], dim=1))
        return torch.sigmoid(self.mask_head(y).float())[:, 0]


def init_unet_(model: UNetMaskDecoder, generator: torch.Generator) -> UNetMaskDecoder:
    """Random weights from `generator`: conv weights lecun_normal
    (`models/init.py`; fan_in = in x kh x kw, a transposed conv's too, as
    flax's kernel [kh, kw, in, out] gives it), zero biases; BatchNorm stays
    at identity (scale 1, shift 0, stats 0 and 1)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                lecun_normal_(m.weight, m.in_channels * m.weight[0, 0].numel(), generator)
                m.bias.zero_()
    return model


def load_reference_state_dict(model: UNetMaskDecoder, sd: dict) -> None:
    """Load a reference UNet state dict, with or without the DDP `module.`
    prefix."""
    model.load_state_dict({k.removeprefix("module."): v for k, v in sd.items()})
