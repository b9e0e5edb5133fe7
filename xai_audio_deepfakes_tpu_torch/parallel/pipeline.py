"""Pipeline parallelism over the transformer layer stack (port of
`parallel/pipeline.py`): GPipe over a "stage" axis of the mesh.

  * each stage holds L/S contiguous layers of the stacked (`scan_layers`)
    stack (`sharding.shard_encoder`), stage s layers [s L/S, (s+1) L/S);
  * the rank's batch splits into M microbatches; at tick t stage s runs its
    layers on microbatch t - s and sends the activation to stage s + 1
    (point-to-point `send` / `recv` over the stage group); after M + S - 1
    ticks the last stage holds every microbatch, and a broadcast over the
    stage group gives every stage the output (JAX's masked psum);
  * the JAX package computes the bubbles' ticks and masks them, as a uniform
    SPMD program wants; here a stage skips a tick that has no microbatch.

The pipeline is differentiable (`_Pipeline`): the forward runs the tick
schedule without a graph and keeps each stage's microbatch inputs; the
backward runs it in reverse, each stage recomputing its layers on a
microbatch with the graph, taking the gradient of its output from the next
stage (the last stage from the output's own gradient), and sending its
input's gradient to the previous stage; stage 0's input gradient is
broadcast back over the stage group, since every stage holds the input.
The stage's parameter gradients accumulate over the microbatches, so the
layers' weights can be trained and held against a plain scan.

It composes with the data axis (each rank pipelines its own batch shard)
and with the model axis (the layers of a stage are tensor-parallel views
whose all-reduces run inside `layer_fn`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from xai_audio_deepfakes_tpu_torch.parallel.mesh import STAGE_AXIS, Mesh


def stack_to_stages(layers, n_stages: int):
    """A stacked layer stack (a sequence of layers, or a tree of arrays with a
    leading [L] axis) ready to split over `n_stages` stages; only validates
    that L divides."""
    if isinstance(layers, dict):
        leaf = layers
        while isinstance(leaf, dict):
            if not leaf:
                raise ValueError("empty layer param tree")
            leaf = next(iter(leaf.values()))
        n = leaf.shape[0]
    else:
        n = len(layers)
        if not n:
            raise ValueError("empty layer stack")
    if n % n_stages:
        raise ValueError(f"{n} layers not divisible by {n_stages} stages")
    return layers


def encoder_layer_fn(cfg):
    """layer_fn for `pipeline_apply`: one `EncoderLayer` (the stage's
    layers are the "params"), checkpointed as `Wav2Vec2Encoder` does with
    `cfg.remat` while a graph is being recorded."""
    from functools import partial

    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    from xai_audio_deepfakes_tpu_torch.models.wav2vec2 import _dots_policy

    if cfg.remat and cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy: {cfg.remat_policy!r}")
    kw = ({"context_fn": partial(create_selective_checkpoint_contexts, _dots_policy)}
          if cfg.remat_policy == "dots" else {})

    def layer_fn(layer, x):
        if cfg.remat and torch.is_grad_enabled() and x.requires_grad:
            return checkpoint(layer, x, use_reentrant=False, **kw)
        return layer(x)

    return layer_fn


class _Stages:
    """This rank's place on the stage axis and its neighbours' global
    ranks."""

    def __init__(self, mesh: Mesh, stage_axis: str):
        self.group = mesh.group(stage_axis)
        self.s, self.n = mesh.index(stage_axis), mesh.size(stage_axis)

        def peer(i):
            return dist.get_global_rank(self.group, i) if self.n > 1 else None

        self.prev = peer(self.s - 1) if self.s > 0 else None
        self.next = peer(self.s + 1) if self.s < self.n - 1 else None
        self.last = peer(self.n - 1)
        self.first = peer(0)

    def broadcast(self, t: torch.Tensor, src) -> torch.Tensor:
        if self.n > 1:
            dist.broadcast(t, src=src, group=self.group)
        return t


def _run_block(layer_fn, layers, x):
    for layer in layers:
        x = layer_fn(layer, x)
    return x


def _schedule(layer_fn, layers, micro: torch.Tensor, st: _Stages, keep: list | None):
    """The forward tick schedule; -> [M, ...] outputs (every stage)."""
    m_count = micro.shape[0]
    outputs = torch.empty_like(micro)
    for t in range(m_count + st.n - 1):
        m = t - st.s
        if not 0 <= m < m_count:
            continue  # a bubble
        if st.s == 0:
            inp = micro[m]
        else:
            inp = torch.empty_like(micro[m])
            dist.recv(inp, src=st.prev)
        if keep is not None:
            keep.append(inp)
        out = _run_block(layer_fn, layers, inp)
        if st.next is not None:
            dist.send(out.contiguous(), dst=st.next)
        else:
            outputs[m] = out
    return st.broadcast(outputs, st.last)


class _Pipeline(torch.autograd.Function):
    """`_schedule` with a backward pass (the module docstring); `params`, the
    stage's trainable parameters, are inputs only so that autograd asks for
    their gradients."""

    @staticmethod
    def forward(ctx, micro, layer_fn, layers, st, *params):
        keep: list = []
        out = _schedule(layer_fn, layers, micro, st, keep)
        ctx.layer_fn, ctx.layers, ctx.st, ctx.keep = layer_fn, layers, st, keep
        return out

    @staticmethod
    def backward(ctx, g_out):
        st, keep = ctx.st, ctx.keep
        params = [p for layer in ctx.layers for p in layer.parameters() if p.requires_grad]
        grads = [None] * len(params)
        g_in = torch.zeros_like(g_out)
        for m in reversed(range(g_out.shape[0])):
            if st.next is None:
                g = g_out[m]
            else:
                g = torch.empty_like(keep[m])
                dist.recv(g, src=st.next)
            with torch.enable_grad():
                inp = keep[m].detach().requires_grad_(True)
                out = _run_block(ctx.layer_fn, ctx.layers, inp)
                got = torch.autograd.grad(out, [inp] + params, g, allow_unused=True)
            if st.prev is not None:
                dist.send(got[0].contiguous(), dst=st.prev)
            else:
                g_in[m] = got[0]
            grads = [a if b is None else b if a is None else a + b
                     for a, b in zip(grads, got[1:])]
        st.broadcast(g_in, st.first)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return (g_in, None, None, None, *grads)


def pipeline_apply(layer_fn, stage_layers, x: torch.Tensor, mesh: Mesh, *,
                   stage_axis: str = STAGE_AXIS, n_micro: int | None = None) -> torch.Tensor:
    """Run this stage's layers `stage_layers` (its contiguous block of the
    stack) as one stage of an S-stage pipeline over `x` [B, ...], this rank's
    batch (its data shard); every stage returns the output of the whole
    stack. layer_fn(layer, x) -> x applies one layer. `n_micro` defaults to
    S, the least that keeps every stage busy in the steady state."""
    s_count = mesh.size(stage_axis)
    m_count = int(n_micro or s_count)
    b = x.shape[0]
    if b % m_count:
        raise ValueError(f"batch {b} not divisible by n_micro={m_count}")
    micro = x.reshape((m_count, b // m_count) + tuple(x.shape[1:]))
    st = _Stages(mesh, stage_axis)
    params = [p for layer in stage_layers for p in layer.parameters() if p.requires_grad]
    if torch.is_grad_enabled() and (x.requires_grad or params):
        out = _Pipeline.apply(micro, layer_fn, list(stage_layers), st, *params)
    else:
        out = _schedule(layer_fn, list(stage_layers), micro, st, None)
    return out.reshape((b,) + tuple(x.shape[1:]))


def pipelined_encoder_apply(cfg, encoder, wav: torch.Tensor, mesh: Mesh, *,
                            n_micro: int | None = None,
                            stage_axis: str = STAGE_AXIS) -> torch.Tensor:
    """`Wav2Vec2Encoder.forward` with its layer stack pipelined: the conv
    frontend, projection and positional conv run on every stage, then the
    stage's layers (`encoder` is this rank's view, `sharding.shard_encoder`,
    holding them) rotate the microbatches; the readout is the encoder's
    (hidden_states[output_layer], final LayerNorm if configured), f32."""
    x = encoder.feature_projection(encoder.feature_encoder(wav))
    x = x + encoder.pos_conv(x)
    x = pipeline_apply(encoder_layer_fn(cfg), encoder.layers, x, mesh, stage_axis=stage_axis,
                       n_micro=n_micro)
    if encoder.final_ln is not None:
        x = encoder.final_ln(x, cfg.layer_norm_eps)
    return x.float()
