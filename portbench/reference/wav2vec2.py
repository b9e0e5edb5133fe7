"""Plain wav2vec2 embedder with stable layer norm (HF `Wav2Vec2Model`,
`do_stable_layer_norm=True`, `feat_extract_norm="layer"`), read out at
`hidden_states[output_layer]`, in the arithmetic a configuration states.

  wav [B, L] -> per-clip zero mean / unit variance (unbiased std + 1e-7)
    -> conv frontend: per layer conv1d -> LayerNorm over channels (f32
       statistics) -> GELU
    -> LayerNorm(C) in f32 -> projection to H
    -> + GELU(grouped positional conv, k 128, 16 groups, padding k // 2, the
       trailing frame dropped)
    -> pre-LN transformer layers: x += out(attn(LN x)); x += ffn(LN x)
    -> features [B, T, H] f32.

Arithmetic ("compute dtype" bf16 or f32):
  * a product (conv, linear) takes its operands in the compute dtype and
    rounds its bias-free result to it, then adds the bias in it;
  * LayerNorms and the softmax are f32 (scores from the compute-dtype q and k
    summed in f32); the probabilities are cast to the compute dtype before
    p . v;
  * GELU in bf16 rounds after each operation, in the order of
    `jax.nn.gelu` on a bf16 array: exact 0.5 x erfc(-x 0.70703125), tanh
    x (0.5 (1 + tanh(0.796875 (x + 0.044677734375 x^3)))).
  * `products="int8"`: the six projections of each layer and the positional
    conv are integer products (`lowp.py`), the float bias added in f32 and the
    sum cast to the compute dtype; the frontend and the feature projection
    stay float.

The control lowers the products one step: "fp8" for a float embedder (every
weight product's operands rounded to e4m3), "int4" for an int8 one.

Weights are a flat dict of tensors (`fe.{i}.conv.weight` [Cout, Cin, k],
`fp.proj.weight` [H, C], `pos.weight` [H, H / G, k], `l{i}.q.weight` [H, H],
...), each in the dtype it is served in.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.lowp import fp8_round, int_grouped_conv1d, int_linear

_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def normalize(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    c = x - x.mean(dim=-1, keepdim=True)
    var = (c * c).sum(dim=-1, keepdim=True) / max(x.shape[-1] - 1, 1)
    return c / (torch.sqrt(var) + 1e-7)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float, dim: int = -1):
    x = x.float()
    mu = x.mean(dim=dim, keepdim=True)
    c = x - mu
    var = (c * c).mean(dim=dim, keepdim=True)
    shape = [1] * x.ndim
    shape[dim] = -1
    return c * torch.rsqrt(var + eps) * w.float().reshape(shape) + b.float().reshape(shape)


def gelu(x: torch.Tensor, kind: str) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        return F.gelu(x, approximate="tanh" if kind == "tanh" else "none")
    if kind == "tanh":
        e = (x + (x * x * x) * 0.044677734375) * 0.796875
        return x * ((torch.tanh(e) + 1.0) * 0.5)
    return (x * 0.5) * torch.special.erfc(-x * 0.70703125)


class _Products:
    """The products of one embedder pass at the precision asked for."""

    def __init__(self, dt: torch.dtype, quantized: str | None, fp8: bool):
        self.dt, self.quantized, self.fp8 = dt, quantized, fp8

    def float_linear(self, x, w, b):
        if self.fp8:
            return F.linear(fp8_round(x, -1), fp8_round(w, 1)).to(self.dt) + b.to(self.dt)
        return F.linear(x.to(self.dt), w.to(self.dt)) + b.to(self.dt)

    def linear(self, x, w, b):
        """A transformer projection: integer where the configuration
        quantizes them."""
        if self.quantized:
            return (int_linear(x, w, self.quantized) + b.float()).to(self.dt)
        return self.float_linear(x, w, b)

    def conv1d(self, x, w, b, stride=1, padding=0, groups=1):
        if self.fp8:
            xr, wr = fp8_round(x, (1, 2)), fp8_round(w, (1, 2))
        else:
            xr, wr = x.to(self.dt), w.to(self.dt)
        y = F.conv1d(xr, wr, None, stride, padding, groups=groups).to(self.dt)
        return y + b.to(self.dt)[:, None]


def embed(weights: dict, wav: torch.Tensor, emb: dict, products: str = "stated") -> torch.Tensor:
    """wav [B, L] -> features [B, T, H] f32. `emb` holds the EmbedderConfig
    fields; `products` is "stated" or "control"."""
    dt = _DT[emb["dtype"]]
    quant = emb.get("quant", "none") != "none"
    if products == "stated":
        prods = _Products(dt, "int8" if quant else None, fp8=False)
    elif products == "control":
        prods = _Products(dt, "int4" if quant else None, fp8=not quant)
    else:
        raise ValueError(products)
    eps, act = emb["layer_norm_eps"], emb["gelu"]
    x = normalize(wav)[:, None, :].to(dt)
    for i, (k, s) in enumerate(zip(emb["conv_kernel"], emb["conv_stride"])):
        y = prods.conv1d(x, weights[f"fe.{i}.conv.weight"], weights[f"fe.{i}.conv.bias"], s)
        y = layer_norm(y, weights[f"fe.{i}.ln.weight"], weights[f"fe.{i}.ln.bias"], eps, dim=1)
        x = gelu(y.to(dt), act)
    y = layer_norm(x.transpose(1, 2), weights["fp.ln.weight"], weights["fp.ln.bias"], eps)
    x = prods.float_linear(y, weights["fp.proj.weight"], weights["fp.proj.bias"])  # [B, T, H]

    kpos, groups = emb["num_conv_pos_embeddings"], emb["num_conv_pos_embedding_groups"]
    wp, bp = weights["pos.weight"], weights["pos.bias"]
    if quant:
        y = int_grouped_conv1d(x.transpose(1, 2), wp, kpos // 2, groups, prods.quantized)
        y = (y + bp.float()[:, None]).to(dt)
    else:
        y = prods.conv1d(x.transpose(1, 2), wp, bp, padding=kpos // 2, groups=groups)
    if kpos % 2 == 0:
        y = y[..., :-1]
    x = x + gelu(y, act).transpose(1, 2)

    nh = emb["num_heads"]
    hd = emb["hidden_size"] // nh
    q_scale = float(torch.tensor(hd ** -0.5).to(dt))
    for i in range(min(emb["num_layers"], emb["output_layer"])):
        p = f"l{i}."
        b, t, h = x.shape
        y = layer_norm(x, weights[p + "attn_ln.weight"], weights[p + "attn_ln.bias"], eps)
        q = prods.linear(y, weights[p + "q.weight"], weights[p + "q.bias"]) * q_scale
        k = prods.linear(y, weights[p + "k.weight"], weights[p + "k.bias"])
        v = prods.linear(y, weights[p + "v.weight"], weights[p + "v.bias"])
        heads = lambda z: z.reshape(b, t, nh, hd).transpose(1, 2).float()  # noqa: E731
        scores = heads(q) @ heads(k).transpose(-1, -2)
        probs = torch.softmax(scores, dim=-1).to(dt).float()
        ctx = (probs @ heads(v)).to(dt).transpose(1, 2).reshape(b, t, h)
        x = x + prods.linear(ctx, weights[p + "o.weight"], weights[p + "o.bias"])
        y = layer_norm(x, weights[p + "ffn_ln.weight"], weights[p + "ffn_ln.bias"], eps)
        hid = gelu(prods.linear(y, weights[p + "ffn_in.weight"], weights[p + "ffn_in.bias"]), act)
        x = x + prods.linear(hid, weights[p + "ffn_out.weight"], weights[p + "ffn_out.bias"])
    return x.float()
