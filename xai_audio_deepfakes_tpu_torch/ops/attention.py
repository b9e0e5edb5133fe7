"""Fused multi-head attention for the embedder: kernel A's wrapper, its plain
version, and the port of `ops/attention.py::attention_reference`.

Activations arrive head-padded, [B, T, NH * HDP] with HDP = 128 and exact
zero pad lanes (the port's `HeadDense` pads the projection weights), and q is
pre-scaled by hd^-0.5. The kernel is `csrc/attention.cu`: in bf16 a
tensor-core body that streams the keys (any T), in f32 a CUDA-core body
whose score tile bounds T (`addv_attention_max_t`).

The kernel is the registered op `addv::attention` (`attention_op`): its CPU
implementation is the plain version, its CUDA implementation launches
kernel A, and its fake implementation gives the output's shape, so that
`torch.export` keeps it as one node of the graph.

The gradient is `_Attention`, around the op: the forward launches the
kernel, the backward recomputes the normalised f32 softmax from the saved q,
k, v and forms dq, dk and dv in plain PyTorch, as `_attention_bwd` of the JAX
package does. It does not differentiate the kernel's own cast points.
"""

from __future__ import annotations

import torch

from xai_audio_deepfakes_tpu_torch.ops import _cuda
from xai_audio_deepfakes_tpu_torch.ops._autograd import needs_grad


def head_pad_dim(hd: int) -> int:
    """Head dim the fused path pads to (a multiple of 128)."""
    return ((hd + 127) // 128) * 128


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v [B, T, NH, HD] (q pre-scaled) -> ctx [B, T, NH, HD]: f32
    softmax, probabilities cast back to the compute dtype before p . v."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nh: int) -> torch.Tensor:
    """Plain version of kernel A, in the kernel's order of operations:
    f32 scores, p = exp(s - rowmax), (p in the compute dtype) . v with f32
    accumulation, then division by the f32 row sum of p."""
    b, t, f = q.shape
    heads = lambda x: x.reshape(b, t, nh, f // nh).transpose(1, 2).float()  # noqa: E731
    qh, kh, vh = heads(q), heads(k), heads(v)
    s = torch.matmul(qh, kh.transpose(-1, -2))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    ctx = torch.matmul(p.to(q.dtype).float(), vh) / p.sum(dim=-1, keepdim=True)
    return ctx.to(q.dtype).transpose(1, 2).reshape(b, t, f)


def attention_backward(q, k, v, nh: int, grad):
    """(dq, dk, dv) of softmax(q k^T) v against `grad`, all [B, T, NH * HDP]:
    f32 throughout, results cast to the inputs' dtype."""
    b, t, f = q.shape
    heads = lambda x: x.float().reshape(b, t, nh, f // nh).transpose(1, 2)  # noqa: E731
    qf, kf, vf, g = heads(q), heads(k), heads(v), heads(grad)  # [B, NH, T, HDP]
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)), dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), g)
    dp = torch.matmul(g, vf.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq, dk = torch.matmul(ds, kf), torch.matmul(ds.transpose(-1, -2), qf)
    flat = lambda x: x.transpose(1, 2).reshape(b, t, f).to(q.dtype)  # noqa: E731
    return flat(dq), flat(dk), flat(dv)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, nh):
        ctx.save_for_backward(q, k, v)
        ctx.nh = nh
        return attention_op(q, k, v, nh)

    @staticmethod
    def backward(ctx, grad):
        return (*attention_backward(*ctx.saved_tensors, ctx.nh, grad), None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nh: int) -> torch.Tensor:
    """[B, T, NH * 128] q, k, v -> ctx of the same shape and dtype. CPU
    tensors take the plain version; CUDA tensors launch kernel A. Carries a
    gradient to q, k and v (`_Attention`)."""
    if needs_grad(q, k, v):
        return _Attention.apply(q, k, v, nh)
    return attention_op(q, k, v, nh)


@torch.library.custom_op(f"{_cuda.NAMESPACE}::attention", mutates_args=(), device_types="cpu")
def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nh: int) -> torch.Tensor:
    """Kernel A as a registered op; on the CPU, the plain version."""
    return attention_plain(q, k, v, nh)


@attention_op.register_fake
def _(q, k, v, nh):
    return torch.empty_like(q)


@attention_op.register_kernel("cuda")
def _attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nh: int) -> torch.Tensor:
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _cuda.require_cuda("attention", q, k, v, dtypes=tuple(_cuda.DTYPE_CODES))
    if not (q.shape == k.shape == v.shape and q.dtype == k.dtype == v.dtype and q.ndim == 3):
        raise ValueError(f"attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, t, f = q.shape
    if f % nh or f // nh != 128:
        raise ValueError(f"attention: the kernel takes head dim 128, got {f} / {nh}")
    lib = _cuda.library()
    if q.dtype == torch.float32 and t > lib.addv_attention_max_t():
        raise ValueError(f"attention: T={t} exceeds the f32 body's score tile")
    out = torch.empty_like(q)
    err = lib.addv_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, nh, f // nh,
        _cuda.DTYPE_CODES[q.dtype], _cuda.stream_handle(q),
    )
    _cuda.check(err, "attention")
    _cuda.LAUNCHES["attention"] += 1
    return out
