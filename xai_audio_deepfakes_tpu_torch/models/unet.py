"""Spectrogram-magnitude -> sigmoid-mask UNet decoder (port of
`models/unet.py::UNetMaskDecoder`), NCHW.

Submodules carry the names of the reference's state dict (`e1.block.0/1/3/4`,
`bottleneck.0/1/3/4`, `up1..4`, `mask_head.0`), so a reference `.pth` loads
with `load_state_dict` once a DDP `module.` prefix is stripped
(`load_reference_state_dict`). Encoder channels 1 -> c -> 2c -> 4c -> 8c,
a dilated 16c bottleneck (d=2, then d=4), transposed-conv decoder with skip
concats, 1x1 conv and a sigmoid. BatchNorm uses eps 1e-5 and, for training,
momentum 0.01 (flax's 0.99 in torch's convention); in training mode
(`model.train()`) it normalises with the batch statistics and updates the
running ones as flax's `nn.BatchNorm` does (`BatchNorm2d` below).

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
from xai_audio_deepfakes_tpu_torch.ops.quant import derived, int8_conv2d, quantize_weight

_BN = dict(eps=1e-5, momentum=0.01)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose running variance follows the BIASED batch
    variance, as flax's `nn.BatchNorm` keeps it. torch folds the unbiased
    estimate, n / (n - 1) times larger with n = B * H * W values per channel,
    into `running_var`; here that update lands in scratch copies (which the
    backward pass keeps) and is rescaled on its way into the buffers. The
    normalisation itself uses the biased variance in both frameworks."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()  # flax nn.BatchNorm(dtype=f32)
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            kept = self.running_var * (1.0 - self.momentum)
            self.running_mean.copy_(mean)
            self.running_var.copy_(kept + (var - kept) * ((n - 1) / n))
            self.num_batches_tracked += 1
        return y


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
    """Random weights from `generator`: conv weights ~ N(0, 1/fan_in), zero
    biases; BatchNorm stays at identity (scale 1, shift 0, stats 0 and 1)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                fan_in = m.in_channels * m.weight[0, 0].numel()
                m.weight.normal_(0.0, fan_in**-0.5, generator=generator)
                m.bias.zero_()
    return model


def load_reference_state_dict(model: UNetMaskDecoder, sd: dict) -> None:
    """Load a reference UNet state dict, with or without the DDP `module.`
    prefix."""
    model.load_state_dict({k.removeprefix("module."): v for k, v in sd.items()})
