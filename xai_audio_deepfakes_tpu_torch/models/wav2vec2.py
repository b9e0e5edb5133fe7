"""Truncated wav2vec2 XLS-R embedder, float path (port of
`models/wav2vec2.py`).

  waveform [B, 80000]
    -> 7 conv layers, each conv -> channel LayerNorm (f32 statistics) ->
       GELU, 320x downsampling -> [B, 512, 249] (kept [B, C, L] throughout,
       the layout F.conv1d takes; the LN+GELU epilogue is kernel D, and with
       `fused_conv` the stride-2 layers 1-6 are kernel E, conv included)
    -> feature projection: LayerNorm(512) in f32 -> Linear(512 -> 1920)
    -> + grouped positional conv (k 128, 16 groups, trailing frame dropped)
    -> 9 pre-LN transformer layers (attention through kernel A)
    -> hidden_states[output_layer], not final-LN'd unless configured.

The weights are frozen in every use the system has (serving, and LMAC
training, where the gradient passes through the embedder to the waveform), so
a gradient flows to the input through the kernels' autograd functions. With
`remat` each transformer layer is recomputed in the backward pass
(`torch.utils.checkpoint`, the "full" policy).

Dense and conv weights are stored in the compute dtype (the JAX package
casts its f32 weights to that dtype at every use, which gives the same
products); LayerNorm parameters stay f32. The q/k/v/out projections are
`HeadDense`: their weights are zero-padded per head from head dim 120 to 128
once, when the weights are set, instead of at every call as the JAX package
does under jit.

flax's `nn.LayerNorm` computes the variance as E[x^2] - E[x]^2; F.layer_norm
uses the centred form. At f32 the two differ by about 1e-6 relative, which
the parity tests' tolerances cover.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from xai_audio_deepfakes_tpu_torch.config import EmbedderConfig
from xai_audio_deepfakes_tpu_torch.device import torch_dtype
from xai_audio_deepfakes_tpu_torch.ops.attention import attention, head_pad_dim
from xai_audio_deepfakes_tpu_torch.ops.cuda_conv import conv_ln_gelu, supports_fused_conv
from xai_audio_deepfakes_tpu_torch.ops.cuda_ln_gelu import ln_gelu


def _gelu(x: torch.Tensor, kind: str) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if kind == "tanh" else "none")


def _init_dense_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    with torch.no_grad():
        weight.normal_(0.0, fan_in**-0.5, generator=generator)


class _LNParams(nn.Module):
    """LayerNorm parameters, f32 (`weight` = flax `scale`, `bias`)."""

    def __init__(self, c: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        """f32 LayerNorm over the last axis (flax `nn.LayerNorm(dtype=f32)`)."""
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, eps)


class ConvLayerNormBlock(nn.Module):
    """conv1d -> channel LayerNorm with f32 statistics (`_LNf32Stats`) ->
    GELU. [B, Cin, L] -> [B, Cout, L']. With `cfg.fused_conv`, a layer that
    kernel E covers runs all three in it; any other layer runs cuDNN's conv
    and kernel D."""

    def __init__(self, cin, cout, kernel, stride, cfg: EmbedderConfig, generator, device):
        super().__init__()
        self.cfg = cfg
        self.fusable = supports_fused_conv(kernel, stride, cin, cout)
        dt = torch_dtype(cfg.dtype)
        self.conv = nn.Conv1d(cin, cout, kernel, stride, bias=cfg.conv_bias,
                              device=device, dtype=dt)
        _init_dense_(self.conv.weight, cin * kernel, generator)
        if cfg.conv_bias:
            nn.init.zeros_(self.conv.bias)
        self.layer_norm = _LNParams(cout, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, ln = self.cfg, self.layer_norm
        if cfg.fused_conv and self.fusable:
            return conv_ln_gelu(x, self.conv.weight, self.conv.bias, ln.weight, ln.bias,
                                cfg.layer_norm_eps, cfg.gelu)
        return ln_gelu(self.conv(x), ln.weight, ln.bias, cfg.layer_norm_eps, cfg.gelu)


class FeatureEncoder(nn.Module):
    def __init__(self, cfg: EmbedderConfig, generator, device):
        super().__init__()
        cins = (1,) + tuple(cfg.conv_dim[:-1])
        self.conv_layers = nn.ModuleList(
            ConvLayerNormBlock(cin, cout, k, s, cfg, generator, device)
            for cin, cout, k, s in zip(cins, cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)
        )
        self.dtype = torch_dtype(cfg.dtype)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:  # [B, L] -> [B, C, T]
        x = wav[:, None, :].to(self.dtype)
        for block in self.conv_layers:
            x = block(x)
        return x


class FeatureProjection(nn.Module):
    def __init__(self, cfg: EmbedderConfig, generator, device):
        super().__init__()
        c = cfg.conv_dim[-1]
        self.eps = cfg.layer_norm_eps
        self.layer_norm = _LNParams(c, device)
        self.projection = nn.Linear(c, cfg.hidden_size, device=device,
                                    dtype=torch_dtype(cfg.dtype))
        _init_dense_(self.projection.weight, c, generator)
        nn.init.zeros_(self.projection.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, T] -> [B, T, H]
        y = self.layer_norm(x.transpose(1, 2), self.eps)
        return self.projection(y.to(self.projection.weight.dtype))


class PositionalConvEmbedding(nn.Module):
    """Grouped conv1d positional embedding; padding k//2 and, for even k,
    the trailing frame dropped (HF Wav2Vec2SamePadLayer). Weight norm is a
    training reparametrisation: the weight here is the effective g * v/|v|."""

    def __init__(self, cfg: EmbedderConfig, generator, device):
        super().__init__()
        h, k, g = cfg.hidden_size, cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
        self.k, self.cfg = k, cfg
        self.conv = nn.Conv1d(h, h, k, padding=k // 2, groups=g, device=device,
                              dtype=torch_dtype(cfg.dtype))
        _init_dense_(self.conv.weight, k * h // g, generator)
        nn.init.zeros_(self.conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, H] -> [B, T, H]
        y = self.conv(x.transpose(1, 2))
        if self.k % 2 == 0:
            y = y[..., :-1]
        return _gelu(y, self.cfg.gelu).transpose(1, 2)


class HeadDense(nn.Module):
    """Attention projection with per-head zero padding of head dim hd to hdp.
    pad_axis=1 pads the outputs (q/k/v give [B, T, NH * hdp] with exact-zero
    pad lanes); pad_axis=0 pads the inputs (out_proj reads the padded
    context). `weight` is [out, in] in the padded layout."""

    def __init__(self, h: int, nh: int, hd: int, pad_axis: int, dtype, generator, device):
        super().__init__()
        hdp = head_pad_dim(hd)
        self.nh, self.hd, self.hdp, self.pad_axis = nh, hd, hdp, pad_axis
        shape = (nh * hdp, h) if pad_axis == 1 else (h, nh * hdp)
        self.weight = nn.Parameter(torch.zeros(shape, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(shape[0], device=device, dtype=dtype))
        dense = torch.empty((h, h), device=device, dtype=dtype)
        _init_dense_(dense, h, generator)
        self.set_dense(dense, torch.zeros(h, device=device))

    def set_dense(self, weight: torch.Tensor, bias: torch.Tensor) -> None:
        """Set from an unpadded torch-layout Linear weight [h, h] and bias [h]."""
        nh, hd, hdp = self.nh, self.hd, self.hdp
        with torch.no_grad():
            self.weight.zero_()
            if self.pad_axis == 1:
                self.weight.view(nh, hdp, -1)[:, :hd].copy_(weight.reshape(nh, hd, -1))
                self.bias.zero_()
                self.bias.view(nh, hdp)[:, :hd].copy_(bias.reshape(nh, hd))
            else:
                self.weight.view(-1, nh, hdp)[:, :, :hd].copy_(weight.reshape(-1, nh, hd))
                self.bias.copy_(bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class EncoderLayer(nn.Module):
    """Pre-LN transformer layer: x += attn(LN(x)); x += ffn(LN(x))."""

    def __init__(self, cfg: EmbedderConfig, generator, device):
        super().__init__()
        h, nh = cfg.hidden_size, cfg.num_heads
        dt = torch_dtype(cfg.dtype)
        self.cfg, self.nh, self.hd = cfg, nh, h // nh
        self.attn_ln = _LNParams(h, device)
        self.q_proj, self.k_proj, self.v_proj = (
            HeadDense(h, nh, self.hd, 1, dt, generator, device) for _ in range(3)
        )
        self.out_proj = HeadDense(h, nh, self.hd, 0, dt, generator, device)
        self.ffn_ln = _LNParams(h, device)
        self.ffn_in = nn.Linear(h, cfg.intermediate_size, device=device, dtype=dt)
        self.ffn_out = nn.Linear(cfg.intermediate_size, h, device=device, dtype=dt)
        for lin in (self.ffn_in, self.ffn_out):
            _init_dense_(lin.weight, lin.in_features, generator)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, H] compute dtype
        eps = self.cfg.layer_norm_eps
        y = self.attn_ln(x, eps)
        q = self.q_proj(y) * self.hd**-0.5
        ctx = attention(q, self.k_proj(y), self.v_proj(y), self.nh)
        x = x + self.out_proj(ctx)
        y = self.ffn_ln(x, eps).to(self.ffn_in.weight.dtype)
        y = _gelu(self.ffn_in(y), self.cfg.gelu)
        return x + self.ffn_out(y)


class Wav2Vec2Encoder(nn.Module):
    """normalised waveform [B, L] -> features [B, T, H] f32
    (== HF hidden_states[output_layer])."""

    def __init__(self, cfg: EmbedderConfig, generator: torch.Generator, device):
        super().__init__()
        self.cfg = cfg
        self.feature_encoder = FeatureEncoder(cfg, generator, device)
        self.feature_projection = FeatureProjection(cfg, generator, device)
        self.pos_conv = PositionalConvEmbedding(cfg, generator, device)
        n_run = min(cfg.output_layer, cfg.num_layers)
        self.layers = nn.ModuleList(EncoderLayer(cfg, generator, device) for _ in range(n_run))
        self.final_ln = _LNParams(cfg.hidden_size, device) if cfg.final_layer_norm else None

    def with_gelu(self, gelu: str) -> "Wav2Vec2Encoder":
        """A second encoder over the SAME parameters whose modules compute
        `gelu` ("exact" | "tanh"): the trainer's gradient-free target pass
        (`TrainConfig.target_gelu`). No weight is copied."""
        shared = {id(p): p for p in self.parameters()}
        view = copy.deepcopy(self, shared)
        cfg = dataclasses.replace(self.cfg, gelu=gelu)
        for module in view.modules():
            if hasattr(module, "cfg"):
                module.cfg = cfg
        return view

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = self.feature_projection(self.feature_encoder(wav))
        x = x + self.pos_conv(x)
        remat = self.cfg.remat and torch.is_grad_enabled() and x.requires_grad
        for layer in self.layers:
            x = checkpoint(layer, x, use_reentrant=False) if remat else layer(x)
        if self.final_ln is not None:
            x = self.final_ln(x, self.cfg.layer_norm_eps)
        return x.float()
