"""HiFi-GAN V1 generator for listenable-explanation synthesis (port of
`models/hifigan.py`).

The reference vocoder is SpeechBrain `tts-hifigan-libritts-16kHz`: HiFi-GAN
V1 with 256x total upsampling (rates 8, 8, 2, 2) to match the hop-256 mel
frontend, multi-receptive-field fusion resblocks (kernels 3, 7, 11,
dilations 1, 3, 5), leaky ReLU 0.1 and tanh out.

Submodules carry the jik876 / SpeechBrain state-dict names (`conv_pre`,
`ups.{i}`, `resblocks.{k}.convs1.{t}` / `convs2.{t}`, `conv_post`), so a
state dict of effective weights loads with `load_state_dict`;
`params_from_torch_state_dict` materialises weight norm first. The
transposed convs are `ConvTranspose1d(padding=(k - rate) // 2)`, which is
flax's VALID transposed conv trimmed by that many samples on each side.

Cast points (those of flax `nn.Conv(dtype=...)` / `nn.ConvTranspose`): the
parameters are f32 and cast at use; each conv computes its bias-free
product in `HiFiGANConfig.dtype` and adds the bias in it; the leaky ReLUs
and the resblock average run in that dtype, the final tanh in f32. The
convolutions are cuDNN's (the JAX package runs them outside any Pallas
kernel too).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from xai_audio_deepfakes_tpu_torch.config import HiFiGANConfig
from xai_audio_deepfakes_tpu_torch.device import torch_dtype


class Conv1d(nn.Conv1d):
    """nn.Conv1d with flax's cast points: the bias-free product in
    `compute`, then the bias in it."""

    def __init__(self, *args, compute=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute = compute

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x.to(self.compute), self.weight.to(self.compute), None, self.stride,
                     self.padding, self.dilation)
        return y + self.bias.to(self.compute)[:, None]


class ConvTranspose1d(nn.ConvTranspose1d):
    """nn.ConvTranspose1d with the same cast points as `Conv1d`."""

    def __init__(self, *args, compute=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute = compute

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose1d(x.to(self.compute), self.weight.to(self.compute), None,
                               self.stride, self.padding)
        return y + self.bias.to(self.compute)[:, None]


class ResBlock1(nn.Module):
    """MRF residual block: per dilation d, x += conv2(lrelu(conv1_d(lrelu(x))))."""

    def __init__(self, channels: int, kernel: int, dilations: tuple, slope: float, compute):
        super().__init__()
        self.slope = slope
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel, dilation=d, padding=(kernel - 1) * d // 2,
                   compute=compute) for d in dilations)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel, padding=(kernel - 1) // 2, compute=compute)
            for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, self.slope)), self.slope))
        return x


class HiFiGANGenerator(nn.Module):
    """log-mel [B, n_mels, T] (or [B, T, n_mels]) -> waveform [B, 256 T] f32."""

    def __init__(self, cfg: HiFiGANConfig = HiFiGANConfig()):
        super().__init__()
        self.cfg = cfg
        dt = self.compute = torch_dtype(cfg.dtype)
        ch = cfg.upsample_initial_channel
        self.conv_pre = Conv1d(cfg.in_channels, ch, 7, padding=3, compute=dt)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for rate, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
            self.ups.append(ConvTranspose1d(ch, ch // 2, k, rate, padding=(k - rate) // 2,
                                            compute=dt))
            ch //= 2
            for rk, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations):
                self.resblocks.append(ResBlock1(ch, rk, dils, cfg.leaky_slope, dt))
        self.conv_post = Conv1d(ch, 1, 7, padding=3, compute=dt)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        # as the JAX module reads it: a last axis of n_mels is [B, T, n_mels]
        x = mel.transpose(-1, -2) if mel.shape[-1] == cfg.in_channels else mel
        x = self.conv_pre(x)
        n_res = len(cfg.resblock_kernel_sizes)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, cfg.leaky_slope))
            acc = None
            for block in self.resblocks[i * n_res:(i + 1) * n_res]:
                y = block(x)
                acc = y if acc is None else acc + y
            x = acc / n_res
        x = self.conv_post(F.leaky_relu(x, cfg.leaky_slope))
        return torch.tanh(x.float())[:, 0]


def init_hifigan_(model: HiFiGANGenerator, generator: torch.Generator) -> HiFiGANGenerator:
    """Random weights from `generator`: conv weights ~ N(0, 1/fan_in), zero
    biases (fan_in = input channels x kernel taps, a transposed conv's too)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.ConvTranspose1d):
                m.weight.normal_(0.0, (m.in_channels * m.kernel_size[0]) ** -0.5,
                                 generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.Conv1d):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=generator)
                m.bias.zero_()
    return model


def _wn(sd: dict, prefix: str) -> np.ndarray:
    """The effective weight of `prefix`: torch weight norm materialised,
    w = g * v / ||v|| (the norm over every dim but 0), from either key
    layout (`parametrizations.weight.original0/1` or `weight_g` /
    `weight_v`), or the plain `weight`."""
    for g_key, v_key in (
        (f"{prefix}.parametrizations.weight.original0", f"{prefix}.parametrizations.weight.original1"),
        (f"{prefix}.weight_g", f"{prefix}.weight_v"),
    ):
        if g_key in sd:
            g = np.asarray(sd[g_key], dtype=np.float32)
            v = np.asarray(sd[v_key], dtype=np.float32)
            axes = tuple(range(1, v.ndim))
            norm = np.sqrt((v * v).sum(axis=axes, keepdims=True))
            return g * v / np.maximum(norm, 1e-12)
    return np.asarray(sd[f"{prefix}.weight"], dtype=np.float32)


def params_from_torch_state_dict(sd: dict, cfg: HiFiGANConfig) -> dict:
    """A jik876 / SpeechBrain HiFi-GAN generator state dict (weight-normed or
    not; values as numpy arrays or CPU tensors) -> a state dict of f32
    effective weights and biases that `HiFiGANGenerator(cfg).load_state_dict`
    takes. Weight norm is materialised in numpy, as the JAX package's
    importer does."""
    sd = {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else v) for k, v in sd.items()}
    prefixes = ["conv_pre", "conv_post"]
    prefixes += [f"ups.{i}" for i in range(len(cfg.upsample_rates))]
    n_res = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        for j in range(n_res):
            for t in range(len(cfg.resblock_dilations[j])):
                prefixes += [f"resblocks.{i * n_res + j}.convs1.{t}",
                             f"resblocks.{i * n_res + j}.convs2.{t}"]
    out = {}
    for prefix in prefixes:
        out[f"{prefix}.weight"] = torch.from_numpy(_wn(sd, prefix))
        out[f"{prefix}.bias"] = torch.from_numpy(np.asarray(sd[f"{prefix}.bias"], np.float32))
    return out
