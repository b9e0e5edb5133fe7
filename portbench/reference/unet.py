"""Plain UNet mask decoder of ADDvisor: STFT magnitude (cropped to
freq_bins x frames) -> sigmoid mask, NCHW.

Encoder blocks (conv -> BatchNorm -> LeakyReLU -> conv 3x3 -> BatchNorm ->
LeakyReLU) with channels 1 -> c -> 2c -> 4c -> 8c: e1 and e2 take a (5, 3)
kernel with stride (2, 1), e3 and e4 a 3x3 kernel with stride 2; a
bottleneck of two dilated 3x3 convs to 16c (dilation 2, then 4); four
transposed convs (kernel = stride: 2x2, 2x2, (2, 1), (2, 1)), each followed
by a concat with the matching encoder output (the input itself last) and a
3x3 block; a 1x1 head and a sigmoid in f32.

Arithmetic, with `dtype` the compute dtype: every conv takes its operands in
`dtype` and rounds its bias-free result to it, then adds the bias in it;
BatchNorm (running statistics) and LeakyReLU run in f32; the skips are cast
to `dtype` before their concat. The control computes one step lower:
bfloat16 for a float32 UNet, float8 e4m3 operands (`lowp.fp8_round`) for a
bfloat16 one.

Weights are the state dict of the reference implementation's module
(`e1.block.0.weight`, `e1.block.1.running_var`, `up4.weight`,
`mask_head.0.bias`, ...), f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.lowp import fp8_round

_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
EPS = 1e-5
MOMENTUM = 0.01  # of the running statistics in training, torch's convention

# (name, cin multiple of c (or 1 for the input), cout multiple, kernel, stride, padding)
ENCODER = (("e1", 0, 1, (5, 3), (2, 1), (2, 1)), ("e2", 1, 2, (5, 3), (2, 1), (2, 1)),
           ("e3", 2, 4, (3, 3), (2, 2), (1, 1)), ("e4", 4, 8, (3, 3), (2, 2), (1, 1)))
# (up name, block name, cin multiple of the up conv, cout multiple, kernel = stride,
#  the skip's channel multiple (0: the 1-channel input))
DECODER = (("up4", "d4", 16, 8, (2, 2), 4), ("up3", "d3", 8, 4, (2, 2), 2),
           ("up2", "d2", 4, 2, (2, 1), 1), ("up1", "d1", 2, 1, (2, 1), 0))


def conv_shapes(c: int) -> dict:
    """{name: (weight shape, transposed)} of every conv of the UNet of base
    width c (the weights' layout, for drawing them)."""
    out = {}
    for name, ci, co, k, _, _ in ENCODER:
        cin = max(ci * c, 1)
        out[f"{name}.block.0"] = ((co * c, cin, *k), False)
        out[f"{name}.block.3"] = ((co * c, co * c, 3, 3), False)
    out["bottleneck.0"] = ((16 * c, 8 * c, 3, 3), False)
    out["bottleneck.3"] = ((16 * c, 16 * c, 3, 3), False)
    for up, blk, ci, co, k, skip in DECODER:
        out[up] = ((ci * c, co * c, *k), True)
        cin = co * c + max(skip * c, 1)
        out[f"{blk}.block.0"] = ((co * c, cin, 3, 3), False)
        out[f"{blk}.block.3"] = ((co * c, co * c, 3, 3), False)
    out["mask_head.0"] = ((1, c, 1, 1), False)
    return out


def batch_norms(c: int) -> dict:
    """{BatchNorm name: channels}."""
    out = {}
    for name, _, co, *_ in ENCODER:
        out[f"{name}.block.1"] = out[f"{name}.block.4"] = co * c
    out["bottleneck.1"] = out["bottleneck.4"] = 16 * c
    for _, blk, _, co, *_ in DECODER:
        out[f"{blk}.block.1"] = out[f"{blk}.block.4"] = co * c
    return out


class _Run:
    def __init__(self, w: dict, dtype: str, control: bool, slope: float, calibrate: bool,
                 train: bool):
        stated = _DT[dtype]
        self.w, self.slope, self.calibrate, self.train = w, slope, calibrate, train
        self.fp8 = control and stated == torch.bfloat16
        self.dt = torch.bfloat16 if control else stated

    def _operands(self, x, weight):
        if self.fp8:
            return fp8_round(x, (1, 2, 3)), fp8_round(weight, (1, 2, 3))
        return x.to(self.dt), weight.to(self.dt)

    def conv(self, name, x, stride=1, padding=0, dilation=1):
        xr, wr = self._operands(x, self.w[name + ".weight"])
        y = F.conv2d(xr, wr, None, stride, padding, dilation).to(self.dt)
        return y + self.w[name + ".bias"].to(self.dt)[:, None, None]

    def up(self, name, x, stride):
        wt = self.w[name + ".weight"]
        if self.fp8:
            xr, wr = fp8_round(x, (1, 2, 3)), fp8_round(wt, (0, 2, 3))
        else:
            xr, wr = x.to(self.dt), wt.to(self.dt)
        y = F.conv_transpose2d(xr, wr, None, stride).to(self.dt)
        return y + self.w[name + ".bias"].to(self.dt)[:, None, None]

    def bn_act(self, name, x):
        x = x.float()
        w = self.w
        shape = (1, -1, 1, 1)
        if self.calibrate:  # the batch's statistics become the running ones
            w[name + ".running_mean"] = x.mean(dim=(0, 2, 3))
            w[name + ".running_var"] = x.var(dim=(0, 2, 3), unbiased=False)
        if self.train:
            return F.leaky_relu(self._batch_norm(name, x), self.slope)
        mean = w[name + ".running_mean"].reshape(shape)
        inv = torch.rsqrt(w[name + ".running_var"].reshape(shape) + EPS)
        y = (x - mean) * (inv * w[name + ".weight"].reshape(shape))
        y = y + w[name + ".bias"].reshape(shape)
        return F.leaky_relu(y, self.slope)

    def _batch_norm(self, name, x):
        """Training: the batch's mean and (biased) variance, E[x^2] - E[x]^2
        from float64 sums of x and x^2, clamped at 0; the running statistics
        move by momentum 0.01."""
        w, n = self.w, x.numel() // x.shape[1]
        s1 = x.sum(dim=(0, 2, 3), dtype=torch.float64)
        s2 = (x * x).sum(dim=(0, 2, 3), dtype=torch.float64)
        mean = s1 / n
        var = torch.clamp_min(s2 / n - mean * mean, 0.0).float()
        mean = mean.float()
        with torch.no_grad():
            for key, stat in ((".running_mean", mean), (".running_var", var)):
                w[name + key] = w[name + key] * (1.0 - MOMENTUM) + stat.detach() * MOMENTUM
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + EPS) * w[name + ".weight"]
        return (x - mean.reshape(shape)) * mul.reshape(shape) + w[name + ".bias"].reshape(shape)

    def block(self, name, x, kernel=(3, 3), stride=(1, 1), padding=(1, 1)):
        x = self.bn_act(f"{name}.block.1", self.conv(f"{name}.block.0", x, stride, padding))
        return self.bn_act(f"{name}.block.4", self.conv(f"{name}.block.3", x, 1, 1))


def forward(w: dict, mag: torch.Tensor, unet: dict, control: bool = False,
            calibrate: bool = False, train: bool = False) -> torch.Tensor:
    """mag [B, freq_bins, frames] -> mask [B, freq_bins, frames] f32. With
    `calibrate` every BatchNorm's running statistics are set, in `w`, to the
    batch's own before it normalises (how the benchmark gives its random
    decoder the statistics of its inputs). With `train` each BatchNorm
    normalises with the batch's statistics and moves its running ones, in
    `w`."""
    r = _Run(w, unet["dtype"], control, unet["leaky_slope"], calibrate, train)
    x = mag[:, None].to(r.dt)
    skips = [x]
    for name, _, _, k, s, p in ENCODER:
        skips.append(r.block(name, skips[-1], k, s, p))
    y = r.bn_act("bottleneck.1", r.conv("bottleneck.0", skips[-1], 1, 2, 2))
    y = r.bn_act("bottleneck.4", r.conv("bottleneck.3", y, 1, 4, 4))
    for (up, blk, _, _, k, _), skip in zip(DECODER, reversed(skips[:-1])):
        y = r.block(blk, torch.cat([r.up(up, y, k), skip.to(r.dt)], dim=1))
    return torch.sigmoid(r.conv("mask_head.0", y).float())[:, 0]
