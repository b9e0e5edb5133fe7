"""Feature-input mask decoder (port of `models/feat_decoder.py`).

    mask = decoder(features [B, 249, 1920])   # -> [B, 512, 249]

The embedder's frames align with the STFT's (hop 322 against the frontend's
320x downsampling: 249 each at 80000 samples), so the mask's time axis is
the feature frames' and its frequency axis the first `freq_bins` bins.

  in LayerNorm -> Dense(hidden) -> GELU
  -> `temporal_blocks` residual blocks x + GELU(conv1d k5 over frames)
  -> `attn_layers` pre-LN blocks: x + MHA(LN x); x + FFN(LN x), FFN 4x wide
  -> out LayerNorm -> Dense(freq_bins) -> sigmoid in f32 -> [B, F, T]

Cast points are flax's, in the compute dtype `cfg.dtype`:
  * `jax.nn.gelu` is the tanh approximation (unlike the embedder's exact
    GELU), rounded after every operation in bf16 (`wav2vec2._gelu`);
  * `nn.LayerNorm` runs in f32 with eps 1e-6 (flax's default, not torch's
    1e-5), then casts;
  * Dense and conv layers round the bias-free product, then add the bias
    (`wav2vec2._dense`, `_conv1d`);
  * `nn.MultiHeadDotProductAttention`: q/k/v projections, the query divided
    by sqrt(head_dim) in the compute dtype before the dot, the softmax in
    the compute dtype (`force_fp32_for_softmax=False`), the output
    projection. This attention is no Pallas kernel in the JAX package, so
    plain torch operations run it on both devices.

Weights are stored torch-style (Linear [out, in], conv [out, in, k]) in the
compute dtype, LayerNorm parameters in f32; `convert.load_feat_decoder`
sets them from flax's tree.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from xai_audio_deepfakes_tpu_torch.config import FeatDecoderConfig
from xai_audio_deepfakes_tpu_torch.device import torch_dtype
from xai_audio_deepfakes_tpu_torch.models.wav2vec2 import (
    Dense,
    _conv1d,
    _gelu,
    _init_dense_,
    _LNParams,
)

LN_EPS = 1e-6  # flax nn.LayerNorm's default epsilon


def _softmax(s: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softmax` over the last axis in s's dtype: in bf16 the shift,
    exp and division round one by one."""
    if s.dtype != torch.bfloat16:
        return torch.softmax(s, dim=-1)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


class SelfAttention(nn.Module):
    """flax `nn.MultiHeadDotProductAttention(num_heads, dtype)(x, x)`:
    `query`, `key`, `value` and `out` projections, each a `Dense` [h, h]
    (flax keeps them as [h, heads, head_dim] and [heads, head_dim, h])."""

    def __init__(self, h: int, heads: int, dtype, generator, device):
        super().__init__()
        self.heads, self.head_dim = heads, h // heads
        self.query, self.key, self.value, self.out = (
            Dense(h, h, dtype, generator, device) for _ in range(4))
        # jnp.sqrt(depth).astype(dtype): sqrt in f32, then the compute dtype
        self.depth_sqrt = float(torch.tensor(math.sqrt(self.head_dim)).to(dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, h]
        b, t, h = x.shape

        def heads(z):
            return z.reshape(b, t, self.heads, self.head_dim)

        q = heads(self.query(x)) / self.depth_sqrt
        k, v = heads(self.key(x)), heads(self.value(x))
        p = _softmax(torch.einsum("bqhd,bkhd->bhqk", q, k))
        return self.out(torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, t, h))


class FeatureMaskDecoder(nn.Module):
    """features [B, T, feature_dim] -> mask [B, freq_bins, T] f32 in (0, 1)."""

    def __init__(self, cfg: FeatDecoderConfig, generator: torch.Generator, device):
        super().__init__()
        self.cfg = cfg
        dt = self.dtype = torch_dtype(cfg.dtype)
        h = cfg.hidden
        self.in_ln = _LNParams(cfg.feature_dim, device)
        self.proj_in = Dense(cfg.feature_dim, h, dt, generator, device)
        self.tconv = nn.ModuleList()
        for _ in range(cfg.temporal_blocks):
            conv = nn.Conv1d(h, h, 5, padding=2, device=device, dtype=dt)
            _init_dense_(conv.weight, 5 * h, generator)
            nn.init.zeros_(conv.bias)
            self.tconv.append(conv)
        n = cfg.attn_layers
        self.attn_ln = nn.ModuleList(_LNParams(h, device) for _ in range(n))
        self.attn = nn.ModuleList(SelfAttention(h, cfg.attn_heads, dt, generator, device)
                                  for _ in range(n))
        self.ffn_ln = nn.ModuleList(_LNParams(h, device) for _ in range(n))
        self.ffn_in = nn.ModuleList()
        self.ffn_out = nn.ModuleList()
        for _ in range(n):
            self.ffn_in.append(Dense(h, 4 * h, dt, generator, device))
            self.ffn_out.append(Dense(4 * h, h, dt, generator, device))
        self.out_ln = _LNParams(h, device)
        self.freq_head = Dense(h, cfg.freq_bins, dt, generator, device)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.dtype
        if feats.shape[-1] != cfg.feature_dim:
            raise ValueError(f"features {tuple(feats.shape)} do not have the decoder's "
                             f"feature_dim {cfg.feature_dim}")
        x = self.in_ln(feats.to(dt), LN_EPS).to(dt)
        x = _gelu(self.proj_in(x), "tanh")
        for conv in self.tconv:
            x = x + _gelu(_conv1d(x.transpose(1, 2), conv).transpose(1, 2), "tanh")
        for i in range(cfg.attn_layers):
            x = x + self.attn[i](self.attn_ln[i](x, LN_EPS).to(dt))
            y = self.ffn_ln[i](x, LN_EPS).to(dt)
            x = x + self.ffn_out[i](_gelu(self.ffn_in[i](y), "tanh"))
        x = self.out_ln(x, LN_EPS).to(dt)
        return torch.sigmoid(self.freq_head(x).float()).transpose(1, 2)
