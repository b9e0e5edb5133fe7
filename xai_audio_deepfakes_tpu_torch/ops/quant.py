"""Symmetric int8 quantization and int8 x int8 -> int32 products for the
serving path (port of `ops/quant.py`).

Scheme, as in the JAX package:
  * activations: per-token scales for dense layers (the last axis),
    per-sample scales for convolutions (every axis but the batch);
  * weights: per-output-channel scales;
  * s = max(max|x| / 127, 1e-12), q = clip(round(x / s), -127, 127) with
    round half to even (`torch.round`, as `jnp.round`);
  * y = acc * (s_x * s_w), with acc the exact int32 sum of int8 products.

`set_int8_hook(hook)` lets a check observe every activation quantization,
int32 product and rescale (`hook(kind, inputs, outputs) -> outputs`, kinds
"quantize_symmetric" with inputs (x f32, dim), "quantize_with_scale" with
(x f32, scale), both with outputs (q, scale); "int_mm" with (a, b) -> acc;
"rescale" with (acc, sx, sw) -> y) and replace what a call returns: record a
run's int8 codes, replay them elsewhere, or pin another run to them. Weight
quantization (`quantize_weight`) is not observed: it is exact and cached.
The hook is off (None) unless a check sets it, and costs one branch a call.

The layouts are the port's: a Linear weight is [N, K], a conv1d weight
[Cout, Cin, k], a conv2d weight [Cout, Cin, kh, kw], activations of a conv
[B, C, L] and [B, C, H, W]. The convolutions form their int8 patches
explicitly (im2col) and contract them with `int_mm`.

In the JAX package these products are XLA `dot_general` and
`conv_general_dilated` with `preferred_element_type=int32`, not Pallas
kernels; here they are `torch._int_mm`. Its CUDA path takes more than 16 rows
and K and N that are multiples of 8, so `int_mm` pads with zero rows and
columns, which add nothing to the sums. The sums stay in int32: at the
positional conv K = 120 * 128 and 127^2 * K exceeds 2^24, where an f32 sum of
the products would round.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from xai_audio_deepfakes_tpu_torch.utils.profiling import span

_FLOOR = 1e-12
_HOOK = None


def set_int8_hook(hook):
    """Install `hook` (None: off); returns the hook it replaces."""
    global _HOOK
    before, _HOOK = _HOOK, hook
    return before


@contextlib.contextmanager
def quant_hook_off():
    """No hook inside the block; the one installed is restored after it."""
    before = set_int8_hook(None)
    try:
        yield
    finally:
        set_int8_hook(before)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8)


def per_127(t: torch.Tensor) -> torch.Tensor:
    """t / 127, divided element by element. A CUDA tensor divided by a
    Python number is multiplied by the number's reciprocal instead, which
    rounds differently from the CPU's (and XLA's) division: a scale one ulp
    off moves every code it divides."""
    return t / torch.full_like(t, 127.0)


def _symmetric_scale(x: torch.Tensor, dim) -> torch.Tensor:
    return torch.clamp_min(per_127(x.abs().amax(dim=dim, keepdim=True)), _FLOOR)


def quantize_symmetric(x: torch.Tensor, dim) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 values, f32 scale that keeps the reduced dims with size 1)."""
    with span("int8.quantize"):
        x = x.float()
        scale = _symmetric_scale(x, dim)
        out = (_quantize(x, scale), scale)
    return out if _HOOK is None else _HOOK("quantize_symmetric", (x, dim), out)


def quantize_scaled(x: torch.Tensor, scale: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (round(x / scale) clipped to +-127 as int8, scale)."""
    with span("int8.quantize"):
        x = x.float()
        out = (_quantize(x, scale), scale)
    return out if _HOOK is None else _HOOK("quantize_with_scale", (x, scale), out)


def quantize_with_scale(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) clipped to +-127, as int8."""
    return quantize_scaled(x, scale)[0]


def rescale(acc: torch.Tensor, sx, sw: torch.Tensor) -> torch.Tensor:
    """The int32 sums back to f32: acc * (sx * sw)."""
    with span("int8.rescale"):
        y = acc.float() * (sx * sw)
    return y if _HOOK is None else _HOOK("rescale", (acc, sx, sw), y)


def derived(module: torch.nn.Module, name: str, fn, *deps: torch.Tensor):
    """fn(*deps), kept on `module` until one of the deps moves to other
    memory (its data pointer) or changes in place (its version counter).
    Serving weights are frozen, so an int8 weight image is computed once per
    weight and per set of static scales. A dep is recognised by its memory,
    not by the tensor object, so a new view of the same scales (the
    per-layer row of `quant_scales`, taken at every call) hits the cache;
    the cache holds the deps, so their memory cannot be reused by another
    tensor while it is kept. Under `torch.export` the deps are the graph's
    inputs, with no memory of their own: the result is computed in the
    graph and kept nowhere."""
    if torch.compiler.is_compiling():
        with torch.no_grad():
            return fn(*deps)
    key = tuple((d.data_ptr(), tuple(d.shape), 0 if d.is_inference() else d._version)
                for d in deps)
    cache = module.__dict__.setdefault("_derived_cache", {})
    hit = cache.get(name)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = cache[name] = (key, fn(*deps), deps)
    return hit[1]


def _pad_to(n: int, m: int, least: int = 0) -> int:
    return max(-(-n // m) * m, least)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a int8 [M, K] @ b int8 [N, K]^T -> int32 [M, N], exact. Pads M to more
    than 16 rows and K and N to multiples of 8 with zeros (the CUDA limits of
    `torch._int_mm`, which the CPU does not have; one path serves both)."""
    m, k = a.shape
    n = b.shape[0]
    mp, kp, np_ = _pad_to(m, 8, 24), _pad_to(k, 8), _pad_to(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        b = F.pad(b, (0, kp - k, 0, np_ - n))
    # b^T in column-major order: the int8 product's preferred operand layout
    out = torch._int_mm(a.contiguous(), b.contiguous().t())[:m, :n]
    return out if _HOOK is None else _HOOK("int_mm", (a[:m, :k], b[:n, :k]), out)


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel quantization of a weight whose dim 0 is the output
    channel -> (int8 [N, ...], f32 scales [N])."""
    w = w.float()
    sw = _symmetric_scale(w, tuple(range(1, w.ndim)))
    return _quantize(w, sw), sw.reshape(-1)


def int8_linear(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                sw: torch.Tensor) -> torch.Tensor:
    """xq int8 [..., K] with scales sx (f32 [..., 1], or a scalar 1 for
    scales already folded into the weight) times a quantized weight
    (wq int8 [N, K], sw f32 [N]) -> f32 [..., N] = acc * (sx * sw)."""
    acc = int_mm(xq.reshape(-1, xq.shape[-1]), wq).reshape(*xq.shape[:-1], wq.shape[0])
    return rescale(acc, sx, sw)


def int8_matmul_prequant(xq: torch.Tensor, sx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Pre-quantized activations (xq int8 [..., K], sx f32 [..., 1]) times
    w^T (w f32 [N, K]) -> [..., N] f32. Several projections of one tensor
    (q/k/v of one LayerNorm output) share the activation's quantization."""
    return int8_linear(xq, sx, *quantize_weight(w))


def fold_static_scales(w: torch.Tensor, s_act: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Static per-channel activation scales s_act [K] folded into w [N, K]:
    sum_k xq[k] s_act[k] w[n, k] = (xq . quantize(w * s_act)[n]) * sw[n]."""
    return quantize_weight(w * s_act)


def int8_matmul_static(xq: torch.Tensor, s_act: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """xq int8 [..., K] quantized as round(x / s_act) with calibrated
    per-channel scales s_act f32 [K] -> [..., N] f32, the scales folded into
    the weight (`fold_static_scales`)."""
    return int8_linear(xq, 1.0, *fold_static_scales(w, s_act))


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] (any float dtype) @ w^T (w f32 [N, K]) -> [..., N] f32 with
    dynamic per-token activation scales."""
    return int8_matmul_prequant(*quantize_symmetric(x, dim=-1), w)


def _patches1d(xq: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """int8 [B, C, L] -> patches [B, L', C * k] in the weight's (Cin, k) order."""
    if pad:
        xq = F.pad(xq, (pad, pad))
    cols = xq.unfold(2, k, stride)  # [B, C, L', k]
    b, c, length, _ = cols.shape
    return cols.permute(0, 2, 1, 3).reshape(b, length, c * k)


def int8_conv1d_q(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1, pad: int = 0,
                  groups: int = 1) -> torch.Tensor:
    """int32 sums of the conv of xq int8 [B, Cin, L] with wq int8
    [Cout, Cin / groups, k] -> [B, L', Cout] (channels last, the products'
    layout), one `int_mm` per group."""
    cout, cg, k = wq.shape
    og = cout // groups
    outs = []
    for g in range(groups):
        cols = _patches1d(xq[:, g * cg:(g + 1) * cg], k, stride, pad)
        b, length, _ = cols.shape
        acc = int_mm(cols.reshape(b * length, -1), wq[g * og:(g + 1) * og].reshape(og, -1))
        outs.append(acc.reshape(b, length, og))
    return outs[0] if groups == 1 else torch.cat(outs, dim=-1)


def int8_conv1d(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                padding: int = 0, quantized: tuple | None = None) -> torch.Tensor:
    """x [B, Cin, L] * weight f32 [Cout, Cin, k] -> f32 [B, L', Cout]
    (channels last): per-sample activation scales over (Cin, L), so a clip's
    output does not depend on its batch neighbours, per-output-channel weight
    scales. `quantized` is `quantize_weight(weight)` where the caller keeps
    it. Serving only: `torch.round` has a zero gradient."""
    xq, sx = quantize_symmetric(x, dim=(1, 2))  # sx [B, 1, 1]
    wq, sw = quantize_weight(weight) if quantized is None else quantized
    acc = int8_conv1d_q(xq, wq, stride, padding)
    return rescale(acc, sx, sw)


def int8_conv2d_q(xq: torch.Tensor, wq: torch.Tensor, stride=(1, 1), padding=(0, 0),
                  dilation=(1, 1)) -> torch.Tensor:
    """int32 sums of the conv of xq int8 [B, Cin, H, W] with wq int8
    [Cout, Cin, kh, kw] -> [B, H', W', Cout] (channels last)."""
    cout, cin, kh, kw = wq.shape
    (ph, pw), (sh, sw), (dh, dw) = padding, stride, dilation
    if ph or pw:
        xq = F.pad(xq, (pw, pw, ph, ph))
    cols = xq.unfold(2, dh * (kh - 1) + 1, sh)[..., ::dh]  # [B, C, H', Wp, kh]
    cols = cols.unfold(3, dw * (kw - 1) + 1, sw)[..., ::dw]  # [B, C, H', W', kh, kw]
    b, _, h, w = cols.shape[:4]
    cols = cols.permute(0, 2, 3, 1, 4, 5).reshape(b * h * w, cin * kh * kw)
    return int_mm(cols, wq.reshape(cout, -1)).reshape(b, h, w, cout)


def int8_conv2d(x: torch.Tensor, weight: torch.Tensor, stride=(1, 1), padding=(0, 0),
                dilation=(1, 1), quantized: tuple | None = None) -> torch.Tensor:
    """x [B, Cin, H, W] * weight f32 [Cout, Cin, kh, kw] -> f32 [B, H', W', Cout]
    (channels last): per-sample activation scales over (Cin, H, W),
    per-output-channel weight scales (`quantized` as in `int8_conv1d`).
    Serving only."""
    xq, sx = quantize_symmetric(x, dim=(1, 2, 3))  # sx [B, 1, 1, 1]
    wq, sw = quantize_weight(weight) if quantized is None else quantized
    return rescale(int8_conv2d_q(xq, wq, stride, padding, dilation), sx, sw)
