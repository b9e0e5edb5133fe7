"""Truncated wav2vec2 XLS-R embedder (port of `models/wav2vec2.py`): the
float path in f32 or bf16 and the int8 serving path.

  waveform [B, 80000]
    -> 7 conv layers, each conv -> channel LayerNorm (f32 statistics) ->
       GELU, 320x downsampling -> [B, 512, 249] (kept [B, C, L] throughout,
       the layout F.conv1d takes)
    -> feature projection: LayerNorm(512) in f32 -> Dense(512 -> 1920)
    -> + grouped positional conv (k 128, 16 groups, trailing frame dropped)
    -> 9 pre-LN transformer layers
    -> hidden_states[output_layer], not final-LN'd unless configured.

The weights are frozen in every use the system has (serving, and LMAC
training, where the gradient passes through the embedder to the waveform), so
a gradient flows to the input through the kernels' autograd functions. With
`remat` each transformer layer is checkpointed (`torch.utils.checkpoint`):
`remat_policy="full"` recomputes all of it in the backward pass, "dots"
saves the products' outputs and recomputes the rest (`_dots_policy`).
`scan_layers` changes only the parameter layout that `convert.load_encoder`
reads (`stack_layer_params`); the layers run in a loop either way.

`params_from_hf_state_dict` / `params_from_hf_dir` map a HF `Wav2Vec2Model`
checkpoint (`model.safetensors`, read by `load_safetensors`, or
`pytorch_model.bin`) onto the JAX package's parameter tree, as numpy
arrays, which `convert.load_encoder` then loads: one mapping path.

Cast points (those of the JAX source, which eager `apply` follows; XLA's
fusion under `jax.jit` drops some of the roundings on the CPU):
  * Dense and conv layers in the compute dtype round the bias-free product to
    that dtype, then add the bias in that dtype (`_dense`, `_conv1d`), as
    flax's `nn.Dense` / `nn.Conv(dtype=...)` do.
  * GELU outside the kernels runs in the compute dtype, rounded after every
    operation in bf16 (`_gelu`).
  * A frontend layer takes kernel D's cast points (GELU in f32 from the
    rounded LayerNorm output) only where the JAX package takes its kernel:
    `fused_ln_gelu` and a channel count that is a multiple of 128
    (`supports_ln_gelu`). Elsewhere it runs `_LNf32Stats` (cast to the
    compute dtype) and `_gelu`. With `fused_conv` the layers kernel E covers
    run E, conv included.
  * Attention: with `fused_attention`, head-padded projections and kernel A;
    without it, unpadded projections and `attention_reference`'s einsum
    order.

Int8 (`quant` "int8" or "int8-static", the `ops/quant.py` scheme): the
positional conv is `_Int8GroupedConv` (per-sample activation scale) and the
six projections of each layer are int8 products, their activations
quantized at four sites (`qkv`, shared by q/k/v, `ctx`, `ffn_in`, `ffn_out`):
per token, or, with `int8-static` and calibrated `act_scales`, per channel
with the scales folded into the weights. `quant_conv="int8"` runs the
frontend layers with Cin >= 64 as int8 convs followed by the unfused
LayerNorm and GELU. Quantized layers keep f32 weights (the JAX package
quantizes its f32 parameters); their int8 images are computed once per
weight and per set of scales (`_derived`), not at every call.

Float Dense and conv weights are stored in the compute dtype (the JAX
package casts its f32 weights to that dtype at every use, which gives the
same products); LayerNorm parameters stay f32. `HeadDense` zero-pads the
q/k/v/out weights per head from head dim 120 to 128 once, when they are set.

flax's `nn.LayerNorm` computes the variance as E[x^2] - E[x]^2; F.layer_norm
uses the centred form. At f32 the two differ by about 1e-6 relative, which
the parity tests' tolerances cover.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import json
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from xai_audio_deepfakes_tpu_torch.config import EmbedderConfig
from xai_audio_deepfakes_tpu_torch.device import torch_dtype
from xai_audio_deepfakes_tpu_torch.models.init import lecun_normal_
from xai_audio_deepfakes_tpu_torch.ops.attention import (
    attention,
    attention_reference,
    head_pad_dim,
)
from xai_audio_deepfakes_tpu_torch.ops.cuda_conv import conv_ln_gelu, supports_fused_conv
from xai_audio_deepfakes_tpu_torch.ops.cuda_ln_gelu import (
    channel_layer_norm,
    ln_gelu,
    supports_ln_gelu,
)
from xai_audio_deepfakes_tpu_torch.ops.cuda_pos_conv import (
    pos_conv,
    pos_conv_grad_image,
    pos_conv_image,
    supports_pos_conv,
)
from xai_audio_deepfakes_tpu_torch.ops.quant import (
    derived,
    fold_static_scales,
    int8_conv1d,
    int8_conv1d_q,
    int8_linear,
    per_127,
    quant_hook_off,
    quantize_scaled,
    quantize_symmetric,
    quantize_weight,
    quantize_with_scale,
    rescale,
)
from xai_audio_deepfakes_tpu_torch.parallel.mesh import copy_to_group, reduce_from_group
from xai_audio_deepfakes_tpu_torch.utils.profiling import span, unrecorded


def _gelu(x: torch.Tensor, kind: str) -> torch.Tensor:
    """GELU in x's dtype ("exact" erf form or the "tanh" approximation).

    In bf16 it rounds after every operation, in the order and with the bf16
    constants of `jax.make_jaxpr(jax.nn.gelu)` on a bf16 array:
      exact: b = 0.5 * x; d = (-x) * 0.70703125; b * erfc(d)
      tanh:  c = 0.044677734375 * (x * x * x); e = 0.796875 * (x + c);
             x * (0.5 * (1 + tanh(e)))
    (every constant is exact in bf16, so torch's f32 arithmetic on a python
    scalar rounds as XLA's bf16 ops do). In f32 it is F.gelu."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x, approximate="tanh" if kind == "tanh" else "none")
    if kind == "tanh":
        e = (x + (x * x * x) * 0.044677734375) * 0.796875
        return x * ((torch.tanh(e) + 1.0) * 0.5)
    return (x * 0.5) * torch.special.erfc(-x * 0.70703125)


def _dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """flax `nn.Dense(dtype=weight.dtype)`: the bias-free product rounded to
    the weight's dtype, then the bias added in that dtype."""
    return F.linear(x.to(weight.dtype), weight) + bias


def _conv1d(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """flax `nn.Conv(dtype=...)` on [B, C, L]: the bias-free convolution in the
    weight's dtype, then the bias added in that dtype."""
    y = F.conv1d(x.to(conv.weight.dtype), conv.weight, None, conv.stride, conv.padding,
                 groups=conv.groups)
    return y if conv.bias is None else y + conv.bias[:, None]


def _init_dense_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    lecun_normal_(weight, fan_in, generator)


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
    """conv1d -> channel LayerNorm with f32 statistics -> GELU, [B, Cin, L] ->
    [B, Cout, L']: kernel E (`fused_conv`, where it covers the layer), the
    conv and kernel D (`fused_ln_gelu` at a channel count D's JAX
    counterpart takes), an int8 conv (`quant_conv`, Cin >= 64) or the conv
    with the unfused LayerNorm and GELU."""

    def __init__(self, cin, cout, kernel, stride, cfg: EmbedderConfig, generator, device):
        super().__init__()
        self.cfg = cfg
        self.fusable = supports_fused_conv(kernel, stride, cin, cout)
        self.quant = cfg.quant_conv == "int8" and cin >= 64
        self.dtype = torch_dtype(cfg.dtype)
        self.conv = nn.Conv1d(cin, cout, kernel, stride, bias=cfg.conv_bias, device=device,
                              dtype=torch.float32 if self.quant else self.dtype)
        _init_dense_(self.conv.weight, cin * kernel, generator)
        if cfg.conv_bias:
            nn.init.zeros_(self.conv.bias)
        self.layer_norm = _LNParams(cout, device)

    def _unfused(self, y: torch.Tensor) -> torch.Tensor:
        """`_LNf32Stats` (cast to the compute dtype), then `_gelu`."""
        ln = self.layer_norm
        normed = channel_layer_norm(y.float(), ln.weight, ln.bias, self.cfg.layer_norm_eps)
        return _gelu(normed.to(self.dtype), self.cfg.gelu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, ln, conv = self.cfg, self.layer_norm, self.conv
        if self.quant:
            wq = derived(self, "wq", quantize_weight, conv.weight)
            y = int8_conv1d(x, conv.weight, conv.stride[0], quantized=wq)  # [B, L', C] f32
            if conv.bias is not None:
                y = y + conv.bias
            return self._unfused(y.to(self.dtype).transpose(1, 2))
        if cfg.fused_conv and self.fusable:
            return conv_ln_gelu(x, conv.weight, conv.bias, ln.weight, ln.bias,
                                cfg.layer_norm_eps, cfg.gelu)
        y = _conv1d(x, conv)
        if cfg.fused_ln_gelu and supports_ln_gelu(conv.out_channels):
            return ln_gelu(y, ln.weight, ln.bias, cfg.layer_norm_eps, cfg.gelu)
        return self._unfused(y)


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


class Dense(nn.Module):
    """A projection y = x W^T + b, W [out, in]: flax `nn.Dense`'s cast points
    (`_dense`), or with `quant` the int8 product of `Int8Dense`, f32 bias
    added, cast to the compute dtype. `forward(x, site)` takes the
    activation's quantization from `site` = (xq, sx, s_act) when several
    projections share one: per-token scales sx, or static per-channel scales
    s_act (sx None), which the weight folds in (`fold_static_scales`)."""

    def __init__(self, fin: int, fout: int, dtype, generator, device, quant: bool = False,
                 shape: tuple | None = None):
        super().__init__()
        self.dtype, self.quant = dtype, quant
        wdt = torch.float32 if quant else dtype
        self.bias = nn.Parameter(torch.zeros(fout if shape is None else shape[0],
                                             device=device, dtype=wdt))
        if shape is None:
            self.weight = nn.Parameter(torch.empty((fout, fin), device=device, dtype=wdt))
            _init_dense_(self.weight, fin, generator)
        else:  # set by the subclass
            self.weight = nn.Parameter(torch.zeros(shape, device=device, dtype=wdt))

    def set_dense(self, weight: torch.Tensor, bias: torch.Tensor) -> None:
        """Set from a torch-layout weight [out, in] and bias [out]."""
        with torch.no_grad():
            self.weight.copy_(weight)
            self.bias.copy_(bias)

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """A row-split shard's bias-free product, in f32: the shards' sum is
        rounded to the weight's dtype once, after the all-reduce, as the
        unsharded product is."""
        return F.linear(x.to(self.weight.dtype).float(), self.weight.float())

    def forward(self, x: torch.Tensor, site=None) -> torch.Tensor:
        if not self.quant:
            return _dense(x, self.weight, self.bias)
        xq, sx, s_act = (*quantize_symmetric(x, dim=-1), None) if site is None else site
        if sx is None:
            wq, sw = derived(self, "static", fold_static_scales, self.weight, s_act)
            y = int8_linear(xq, 1.0, wq, sw)
        else:
            y = int8_linear(xq, sx, *derived(self, "dynamic", quantize_weight, self.weight))
        return (y + self.bias).to(self.dtype)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: EmbedderConfig, generator, device):
        super().__init__()
        c = cfg.conv_dim[-1]
        self.eps = cfg.layer_norm_eps
        self.layer_norm = _LNParams(c, device)
        self.projection = Dense(c, cfg.hidden_size, torch_dtype(cfg.dtype), generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, T] -> [B, T, H]
        return self.projection(self.layer_norm(x.transpose(1, 2), self.eps))


def _quantize_floor_first(x: torch.Tensor, dim) -> tuple[torch.Tensor, torch.Tensor]:
    """`_Int8GroupedConv`'s quantization: s = max(max|x|, 1e-12) / 127 (the
    floor before the division, unlike `quantize_symmetric`)."""
    with span("int8.quantize"):
        x = x.float()
        scale = per_127(torch.clamp_min(x.abs().amax(dim=dim, keepdim=True), 1e-12))
    return quantize_scaled(x, scale)


def _quantize_weight_floor_first(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`_quantize_floor_first` of a conv weight per output channel, not
    observed by the int8 hook (`ops/quant.py`), as `quantize_weight` is not."""
    with quant_hook_off():
        return _quantize_floor_first(w, (1, 2))


class PositionalConvEmbedding(nn.Module):
    """Grouped conv1d positional embedding; padding k//2 and, for even k,
    the trailing frame dropped (HF Wav2Vec2SamePadLayer). Weight norm is a
    training reparametrisation: the weight here is the effective g * v/|v|.
    With `quant` the conv is `_Int8GroupedConv`: one activation scale per
    sample (over time and channels, so a clip's output does not depend on
    its batch neighbours), one weight scale per output channel, int32 sums,
    the f32 bias added and the result cast to x's dtype. Otherwise bf16 on
    a card takes kernel F (`takes_kernel`) on x's own [B, T, H] layout, the
    dropped frame never computed, with the weight's two images kept per
    weight (`derived`); everything else takes `_conv1d`."""

    def __init__(self, cfg: EmbedderConfig, generator, device):
        super().__init__()
        h, k, g = cfg.hidden_size, cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
        self.k, self.cfg = k, cfg
        self.quant = cfg.quant != "none"
        self.conv = nn.Conv1d(h, h, k, padding=k // 2, groups=g, device=device,
                              dtype=torch.float32 if self.quant else torch_dtype(cfg.dtype))
        _init_dense_(self.conv.weight, k * h // g, generator)
        nn.init.zeros_(self.conv.bias)

    def _int8(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, H] -> [B, T', H]
        conv = self.conv
        xq, sx = _quantize_floor_first(x, dim=(1, 2))  # sx [B, 1, 1]
        wq, sw = derived(self, "wq", _quantize_weight_floor_first, conv.weight)
        acc = int8_conv1d_q(xq.transpose(1, 2), wq, 1, conv.padding[0], conv.groups)
        return (rescale(acc, sx, sw.reshape(-1)) + conv.bias).to(x.dtype)

    def takes_kernel(self, device_type: str, dtype: torch.dtype) -> bool:
        """Kernel F runs the float path's conv where it applies: bf16
        activations and weights on a card, stride 1, a group width and
        tap count it is built for."""
        conv = self.conv
        h, cg, k = conv.weight.shape
        return (not self.quant and device_type == "cuda" and dtype == torch.bfloat16
                and conv.weight.dtype == torch.bfloat16 and conv.stride == (1,)
                and conv.dilation == (1,) and supports_pos_conv(k, cg))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, H] -> [B, T, H]
        if self.quant:
            y = self._int8(x)
            return _gelu(y[:, :-1] if self.k % 2 == 0 else y, self.cfg.gelu)
        conv = self.conv
        if self.takes_kernel(x.device.type, x.dtype):
            image = derived(self, "pos_conv", pos_conv_image, conv.weight)
            grad_image = (derived(self, "pos_conv_dgrad", pos_conv_grad_image, conv.weight)
                          if torch.is_grad_enabled() and x.requires_grad else None)
            y = pos_conv(x, conv.weight, conv.bias, conv.padding[0], image, grad_image)
            return _gelu(y, self.cfg.gelu)
        y = _conv1d(x.transpose(1, 2), conv)
        if self.k % 2 == 0:
            y = y[..., :-1]
        return _gelu(y, self.cfg.gelu).transpose(1, 2)


class HeadDense(Dense):
    """Attention projection with per-head zero padding of head dim hd to hdp.
    pad_axis=1 pads the outputs (q/k/v give [B, T, NH * hdp] with exact-zero
    pad lanes); pad_axis=0 pads the inputs (out_proj reads the padded
    context). `weight` is [out, in] in the padded layout. The zero pad
    columns and rows survive int8 quantization as exact zeros."""

    def __init__(self, h: int, nh: int, hd: int, pad_axis: int, dtype, generator, device,
                 quant: bool = False):
        hdp = head_pad_dim(hd)
        shape = (nh * hdp, h) if pad_axis == 1 else (h, nh * hdp)
        super().__init__(h, h, dtype, generator, device, quant, shape=shape)
        self.nh, self.hd, self.hdp, self.pad_axis = nh, hd, hdp, pad_axis
        dense = torch.empty((h, h), device=device, dtype=self.weight.dtype)
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


def _quantile(a: torch.Tensor, q: float) -> torch.Tensor:
    """`jnp.quantile(a, q, axis=0)` for a [N, C] f32: linear interpolation
    between the order statistics floor(q (N - 1)) and ceil(q (N - 1)),
    weights computed in f32. Takes the few largest values per channel
    (`topk`) instead of a sort; `torch.quantile` refuses inputs of more than
    2^24 elements, which the full-width FFN site exceeds."""
    n = a.shape[0]
    pos = torch.tensor(q, dtype=torch.float32) * float(n - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    w_lo = 1.0 - w_hi
    top = torch.topk(a, n - int(lo), dim=0).values  # descending: top[-1] is order stat lo
    return top[-1] * w_lo.to(a.device) + top[-1 - int(hi - lo)] * w_hi.to(a.device)


def _absmax_stats(t: torch.Tensor) -> torch.Tensor:
    """[..., C] -> [2, C]: the per-channel max of |t| and its 99.9th
    percentile over the tokens (`EncoderLayer(collect_absmax=True)`)."""
    t32 = t.float().abs().reshape(-1, t.shape[-1])
    return torch.stack([t32.amax(dim=0), _quantile(t32, 0.999)])


class EncoderLayer(nn.Module):
    """Pre-LN transformer layer: x += attn(LN(x)); x += ffn(LN(x)).

    `act_scales` ({site: [C_site] f32}) selects static per-channel activation
    scales (`quant="int8-static"`); `collect_absmax` also returns
    {site: [2, C_site]} (`_absmax_stats`) for calibration. The `ctx` site is
    NH * 128 wide with `fused_attention` (the head-padded context) and H wide
    without.

    After `tensor_parallel(...)` the layer holds one rank's Megatron block and
    its process group (`tp_group`, on the module): its heads of q/k/v and the
    matching columns of out_proj, its columns of the FFN. The LayerNorm
    outputs enter the column-split products through `copy_to_group` (their
    gradient summed over the group), and each row-split product is taken in
    f32 (`Dense.partial`), summed over the group in f32
    (`reduce_from_group`), rounded to the compute dtype and its bias added,
    once. Without a group the layer computes exactly the unsharded
    products."""

    tp_group = None

    def __init__(self, cfg: EmbedderConfig, generator, device):
        super().__init__()
        h, nh = cfg.hidden_size, cfg.num_heads
        dt = torch_dtype(cfg.dtype)
        quant = cfg.quant != "none"
        self.cfg, self.nh, self.hd, self.quant = cfg, nh, h // nh, quant
        # hd^-0.5 in the compute dtype, as JAX multiplies by a weakly typed scalar
        self.q_scale = float(torch.tensor(self.hd**-0.5).to(dt))
        self.attn_ln = _LNParams(h, device)
        if cfg.fused_attention:
            self.q_proj, self.k_proj, self.v_proj = (
                HeadDense(h, nh, self.hd, 1, dt, generator, device, quant) for _ in range(3))
            self.out_proj = HeadDense(h, nh, self.hd, 0, dt, generator, device, quant)
        else:
            self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
                Dense(h, h, dt, generator, device, quant) for _ in range(4))
        self.ffn_ln = _LNParams(h, device)
        self.ffn_in = Dense(h, cfg.intermediate_size, dt, generator, device, quant)
        self.ffn_out = Dense(cfg.intermediate_size, h, dt, generator, device, quant)

    def forward(self, x: torch.Tensor, act_scales: dict | None = None,
                collect_absmax: bool = False):  # x [B, T, H] in the compute dtype
        cfg, nh, hd = self.cfg, self.nh, self.hd
        if collect_absmax and not self.quant:
            raise ValueError("collect_absmax calibrates the int8 activation-quantize sites; "
                             "set quant to 'int8' or 'int8-static'")
        absmax: dict = {}

        def site(t: torch.Tensor, name: str):
            if not self.quant:
                return None
            if collect_absmax:
                absmax[name] = _absmax_stats(t)
            if act_scales is not None:
                # kept, so that the weight fold keyed on it is kept too
                s = derived(self, name, lambda a: torch.clamp_min(a, 1e-12), act_scales[name])
                return quantize_with_scale(t, s), None, s
            return (*quantize_symmetric(t, dim=-1), None)

        x = x + self._row_split(self.out_proj, *self.attention_context(x, site))
        out = x + self._row_split(self.ffn_out, *self.ffn_hidden(x, site))
        return (out, absmax) if collect_absmax else out

    def attention_context(self, x: torch.Tensor, site=lambda t, name: None):
        """LN -> q/k/v -> attention: (the context out_proj takes, its int8
        site)."""
        cfg, nh, hd = self.cfg, self.nh, self.hd
        y = copy_to_group(self.attn_ln(x, cfg.layer_norm_eps), self.tp_group)
        qkv = site(y, "qkv")
        q = self.q_proj(y, qkv) * self.q_scale
        k, v = self.k_proj(y, qkv), self.v_proj(y, qkv)
        if cfg.fused_attention:
            ctx = attention(q, k, v, nh)  # [B, T, NH * HDP]
        else:
            b, t = q.shape[:2]
            heads = lambda z: z.reshape(b, t, nh, hd)  # noqa: E731
            ctx = attention_reference(heads(q), heads(k), heads(v)).reshape(b, t, nh * hd)
        return ctx, site(ctx, "ctx")

    def ffn_hidden(self, x: torch.Tensor, site=lambda t, name: None):
        """LN -> ffn_in -> GELU: (the hidden ffn_out takes, its int8 site)."""
        y = copy_to_group(self.ffn_ln(x, self.cfg.layer_norm_eps), self.tp_group)
        y = _gelu(self.ffn_in(y, site(y, "ffn_in")), self.cfg.gelu)
        return y, site(y, "ffn_out")

    def _row_split(self, dense: Dense, t: torch.Tensor, site) -> torch.Tensor:
        if self.tp_group is None:
            return dense(t, site)
        return reduce_from_group(dense.partial(t), self.tp_group).to(dense.weight.dtype) + dense.bias

    def tensor_parallel(self, index: int, size: int, group, splits: dict) -> None:
        """Keep block `index` of `size` of each projection, in place:
        `splits` maps each projection's name to (the weight dim it splits or
        None, the bias dim or None), `parallel/sharding.py`'s specs in torch
        layout; then run with the all-reduces over `group`. The head count
        becomes this rank's. New parameters replace the split ones, so a
        module that shares the old ones keeps them whole."""
        from xai_audio_deepfakes_tpu_torch.parallel.sharding import _block

        for name, (wdim, bdim) in splits.items():
            dense = getattr(self, name)
            for attr, dim in (("weight", wdim), ("bias", bdim)):
                if dim is not None:
                    p = getattr(dense, attr)
                    setattr(dense, attr, nn.Parameter(_block(p.detach(), dim, index, size).clone(),
                                                      requires_grad=p.requires_grad))
            if isinstance(dense, HeadDense):
                dense.nh //= size
        self.nh //= size
        self.tp_group = group


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten._int_mm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """`remat_policy="dots"`: keep every product's output for the backward
    pass and recompute everything else (LayerNorms, GELUs, casts, bias adds,
    softmax), as `jax.checkpoint_policies.checkpoint_dots` keeps every
    `dot_general`. Kernel A is no product here: its forward is recomputed,
    as the Pallas call is under `checkpoint_dots`."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


class Wav2Vec2Encoder(nn.Module):
    """normalised waveform [B, L] -> features [B, T, H] f32
    (== HF hidden_states[output_layer])."""

    stage = None  # (index, count) of a pipeline stage's view (`parallel/sharding.py`)

    def __init__(self, cfg: EmbedderConfig, generator: torch.Generator, device):
        super().__init__()
        self.cfg = cfg
        self.feature_encoder = FeatureEncoder(cfg, generator, device)
        self.feature_projection = FeatureProjection(cfg, generator, device)
        self.pos_conv = PositionalConvEmbedding(cfg, generator, device)
        n_run = min(cfg.output_layer, cfg.num_layers)
        self.layers = nn.ModuleList(EncoderLayer(cfg, generator, device) for _ in range(n_run))
        self.final_ln = _LNParams(cfg.hidden_size, device) if cfg.final_layer_norm else None

    def _remat_kwargs(self) -> dict:
        if self.cfg.remat_policy == "dots":
            return {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                                    _dots_policy)}
        return {}

    def with_config(self, gelu: str, quant: str) -> "Wav2Vec2Encoder":
        """A second encoder over the SAME parameters whose modules compute
        `gelu` ("exact" | "tanh") and whose transformer layers and positional
        conv take `quant` ("none" | "int8": dynamic per-token int8 products
        of the weights as they are stored): the trainer's gradient-free
        target pass (`TrainConfig.target_gelu`, `target_quant`). No weight is
        copied; the int8 images are kept on the second module."""
        shared = {id(p): p for p in self.parameters()}
        shared.update({id(layer.tp_group): layer.tp_group for layer in self.layers})
        view = copy.deepcopy(self, shared)
        cfg = dataclasses.replace(self.cfg, gelu=gelu, quant=quant)
        q = quant != "none"
        for module in view.modules():
            if hasattr(module, "cfg"):
                module.cfg = cfg
            # every module whose quant flag follows cfg.quant at construction
            if isinstance(module, (EncoderLayer, PositionalConvEmbedding)):
                module.quant = q
        for layer in view.layers:
            for dense in (layer.q_proj, layer.k_proj, layer.v_proj, layer.out_proj,
                          layer.ffn_in, layer.ffn_out):
                dense.quant = q
        return view

    def forward(self, wav: torch.Tensor, act_scales: dict | None = None,
                calibrate: bool = False):
        """`act_scales` ({site: [n_layers, C_site]}, `quant="int8-static"`)
        are the calibrated static scales; `calibrate=True` returns
        (features, {site: [n_layers, 2, C_site]}), the per-layer statistics
        of `_absmax_stats`."""
        if act_scales is not None and self.cfg.quant != "int8-static":
            raise ValueError("act_scales only applies with quant='int8-static'")
        if self.stage is not None:
            raise ValueError("this encoder holds one pipeline stage's layers: run it with "
                             "parallel.pipeline.pipelined_encoder_apply")
        with span("embed.frontend"):
            x = self.feature_encoder(wav)
        with span("embed.projection"):
            x = self.feature_projection(x)
        with span("embed.pos_conv"):
            x = x + self.pos_conv(x)
        remat = self.cfg.remat and torch.is_grad_enabled() and x.requires_grad
        stats = []
        with span("embed.layers"):
            for i, layer in enumerate(self.layers):
                scales = None if act_scales is None else {s: a[i] for s, a in act_scales.items()}
                if calibrate:
                    x, absmax = layer(x, scales, collect_absmax=True)
                    stats.append(absmax)
                elif remat:
                    x = checkpoint(unrecorded(layer), x, scales, use_reentrant=False,
                                   **self._remat_kwargs())
                else:
                    x = layer(x, scales)
            if self.final_ln is not None:
                x = self.final_ln(x, self.cfg.layer_norm_eps)
            x = x.float()
        if calibrate:
            return x, {s: torch.stack([m[s] for m in stats]) for s in stats[0]}
        return x


# ---------------------------------------------------------------------------
# Weight import from HF checkpoints
# ---------------------------------------------------------------------------


def _wn_effective_weight(sd: dict, prefix: str) -> np.ndarray:
    """Materialise torch weight_norm(conv, dim=2): w = g * v / ||v|| over
    axes (0, 1), from either key form (`parametrizations.weight.original0/1`
    or `weight_g` / `weight_v`); a plain `weight` is taken as it is."""
    for g_key, v_key in (
        (f"{prefix}.parametrizations.weight.original0", f"{prefix}.parametrizations.weight.original1"),
        (f"{prefix}.weight_g", f"{prefix}.weight_v"),
    ):
        if g_key in sd:
            g = np.asarray(sd[g_key], dtype=np.float32)
            v = np.asarray(sd[v_key], dtype=np.float32)
            norm = np.sqrt((v * v).sum(axis=(0, 1), keepdims=True))
            return g * v / np.maximum(norm, 1e-12)
    return np.asarray(sd[f"{prefix}.weight"], dtype=np.float32)


def tree_map(fn, *trees):
    """fn over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_layer_params(p: dict, n_layers: int) -> dict:
    """Unrolled `layer_{i}` subtrees -> the scanned layout (`layers/layer`
    with a leading [n_layers] axis). In place on `p`."""
    layers = [p.pop(f"layer_{i}") for i in range(n_layers)]
    p["layers"] = {"layer": tree_map(lambda *xs: np.stack(xs), *layers)}
    return p


def params_from_hf_state_dict(sd: dict, cfg: EmbedderConfig) -> dict:
    """A HF `Wav2Vec2Model` state dict (do_stable_layer_norm=True,
    feat_extract_norm="layer"; numpy values) -> {"params":
    tree} in the JAX package's layout, numpy f32: torch conv [out, in, k] ->
    [k, in, out], Linear [out, in] -> [in, out]. Takes min(cfg.num_layers,
    layers in `sd`) layers, stacked under `scan_layers`."""

    def arr(key):
        return np.asarray(sd[key], dtype=np.float32)

    p: dict = {"feature_encoder": {}}
    for i in range(len(cfg.conv_dim)):
        pre = f"feature_extractor.conv_layers.{i}"
        blk = {
            "conv": {"kernel": arr(f"{pre}.conv.weight").transpose(2, 1, 0)},
            "layer_norm": {"scale": arr(f"{pre}.layer_norm.weight"),
                           "bias": arr(f"{pre}.layer_norm.bias")},
        }
        if cfg.conv_bias:
            blk["conv"]["bias"] = arr(f"{pre}.conv.bias")
        p["feature_encoder"][f"conv_{i}"] = blk

    p["feature_projection"] = {
        "layer_norm": {"scale": arr("feature_projection.layer_norm.weight"),
                       "bias": arr("feature_projection.layer_norm.bias")},
        "projection": {"kernel": arr("feature_projection.projection.weight").T,
                       "bias": arr("feature_projection.projection.bias")},
    }
    w_eff = _wn_effective_weight(sd, "encoder.pos_conv_embed.conv")  # [out, in/g, k]
    p["pos_conv"] = {"conv": {"kernel": w_eff.transpose(2, 1, 0),
                              "bias": arr("encoder.pos_conv_embed.conv.bias")}}

    def dense(key):
        return {"kernel": arr(f"{key}.weight").T, "bias": arr(f"{key}.bias")}

    n_avail = 0
    while f"encoder.layers.{n_avail}.layer_norm.weight" in sd:
        n_avail += 1
    n = min(cfg.num_layers, n_avail)
    for i in range(n):
        pre = f"encoder.layers.{i}"
        p[f"layer_{i}"] = {
            "attn_ln": {"scale": arr(f"{pre}.layer_norm.weight"),
                        "bias": arr(f"{pre}.layer_norm.bias")},
            "q_proj": dense(f"{pre}.attention.q_proj"),
            "k_proj": dense(f"{pre}.attention.k_proj"),
            "v_proj": dense(f"{pre}.attention.v_proj"),
            "out_proj": dense(f"{pre}.attention.out_proj"),
            "ffn_ln": {"scale": arr(f"{pre}.final_layer_norm.weight"),
                       "bias": arr(f"{pre}.final_layer_norm.bias")},
            "ffn_in": dense(f"{pre}.feed_forward.intermediate_dense"),
            "ffn_out": dense(f"{pre}.feed_forward.output_dense"),
        }
    if cfg.final_layer_norm and "encoder.layer_norm.weight" in sd:
        p["final_ln"] = {"scale": arr("encoder.layer_norm.weight"),
                         "bias": arr("encoder.layer_norm.bias")}
    if cfg.scan_layers:
        stack_layer_params(p, n)
    return {"params": p}


_SAFETENSORS_DTYPES = {"F32": "<f4", "F16": "<f2"}


def load_safetensors(path: str) -> dict:
    """Read a `.safetensors` file into {name: numpy array}: an 8-byte
    little-endian header length, a JSON header {name: {dtype, shape,
    data_offsets}} (and an optional `__metadata__`), then the raw
    little-endian data. F32 and F16 keep their dtype, as views of the
    file's bytes read into memory; BF16, which numpy lacks, is read through
    torch and returned as f32 (exact). Any other dtype raises."""
    raw = np.fromfile(path, dtype=np.uint8)
    n = int.from_bytes(raw[:8].tobytes(), "little")
    header = json.loads(raw[8:8 + n].tobytes())
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = (base + o for o in info["data_offsets"])
        shape = tuple(info["shape"])
        buf = raw[start:end]
        if info["dtype"] == "BF16":
            bits = torch.from_numpy(buf.copy().view(np.int16))
            out[name] = bits.view(torch.bfloat16).float().numpy().reshape(shape)
        elif info["dtype"] in _SAFETENSORS_DTYPES:
            out[name] = buf.view(_SAFETENSORS_DTYPES[info["dtype"]]).reshape(shape)
        else:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
    return out


def params_from_hf_dir(model_dir: str, cfg: EmbedderConfig) -> dict:
    """`params_from_hf_state_dict` of a local HF checkpoint directory:
    `model.safetensors` when it is there, else `pytorch_model.bin` (loaded
    with `weights_only=True`); the `wav2vec2.` prefix of a
    `Wav2Vec2ForPreTraining`-style checkpoint is stripped."""
    st_path = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st_path):
        sd = load_safetensors(st_path)
    else:
        sd = torch.load(os.path.join(model_dir, "pytorch_model.bin"), map_location="cpu",
                        weights_only=True)
        sd = {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
              for k, v in sd.items()}
    sd = {k.removeprefix("wav2vec2."): v for k, v in sd.items()}
    return params_from_hf_state_dict(sd, cfg)
