"""Process groups and the device mesh (port of `parallel/mesh.py`) on
`torch.distributed`.

One process per device. The mesh is a `DeviceMesh` over the world with the
dims (data, "stage", model): the batch splits over data, the embedder's layer
stack over "stage" (`parallel/pipeline.py`), its Megatron dims over model
(`parallel/sharding.py`). Every rank holds plain tensors: its batch shard,
its parameter shards, and explicit collectives move data between them, so
that every kernel op sees an ordinary local tensor.

The backend follows the device: NCCL for "cuda", gloo for "cpu"; neither
stands in for the other. Launch with `torchrun --nproc-per-node N` (its
environment gives the rendezvous) or spawn the processes and pass
`init_method`, `world_size` and `rank`; a process started alone joins a
world of one.

The differentiable collectives below take their process group as an
argument and keep it on the autograd context: on the card autograd runs a
backward pass in a thread of its own, where any per-thread state of the
forward's thread is absent.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import torch
import torch.distributed as dist

from xai_audio_deepfakes_tpu_torch.config import MeshConfig
from xai_audio_deepfakes_tpu_torch.device import resolve_device

STAGE_AXIS = "stage"


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_distributed(device="cuda", init_method: str | None = None,
                           world_size: int | None = None, rank: int | None = None) -> None:
    """Join the default process group once per process, with the backend
    of `device`. Without `init_method`, torchrun's environment (`RANK`,
    `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`) when it is set, else a world
    of one on a free localhost port. On the card each process takes the
    device `LOCAL_RANK` (else its rank modulo the device count). A group
    already joined with another backend raises."""
    dev = resolve_device(device)
    backend = backend_for(dev)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(f"the process group runs {have}; {dev.type} needs {backend}")
        return
    if init_method is None:
        if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
            init_method = "env://"
        else:
            init_method, world_size, rank = f"tcp://localhost:{_free_port()}", 1, 0
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, "stage", model) `DeviceMesh` and the names of its axes.
    `shape` maps each axis name to its size, as a JAX mesh's does."""

    device_mesh: object
    cfg: MeshConfig
    device: torch.device

    @property
    def axes(self) -> tuple:
        return (self.cfg.data_axis, STAGE_AXIS, self.cfg.model_axis)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axes, self.device_mesh.mesh.shape))

    def size(self, axis: str) -> int:
        return int(self.shape[axis])

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis`."""
        return int(self.device_mesh.get_local_rank(axis))

    def group(self, axis: str):
        """The process group of the ranks that differ from this one only on
        `axis`."""
        return self.device_mesh.get_group(axis)


def make_mesh(cfg: MeshConfig = MeshConfig(), device="cuda", pipeline_stages: int = 1,
              data_parallel: int = 0) -> Mesh:
    """The mesh of shape (dp, pipeline_stages, cfg.model_parallel) over the
    world, joined first if it is not (`initialize_distributed`). dp defaults
    to what the world leaves; a product dp x pp x tp other than the world
    size raises."""
    dev = resolve_device(device)
    initialize_distributed(dev)
    world = dist.get_world_size()
    pp, tp = int(pipeline_stages), int(cfg.model_parallel)
    if pp < 1 or tp < 1:
        raise ValueError(f"pipeline_stages {pp} and model_parallel {tp} must be at least 1")
    dp = int(data_parallel) or world // (pp * tp)
    if dp * pp * tp != world:
        raise ValueError(f"data {dp} x stages {pp} x model {tp} = {dp * pp * tp} ranks, but the "
                         f"world has {world}")
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, (dp, pp, tp),
                          mesh_dim_names=(cfg.data_axis, STAGE_AXIS, cfg.model_axis))
    return Mesh(dm, cfg, dev)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def batch_sharding(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's shard of the batch (leading) axis over the data axis,
    the rest whole. The batch must divide by the data axis's size."""
    dp, i = mesh.size(mesh.cfg.data_axis), mesh.index(mesh.cfg.data_axis)
    if x.shape[0] % dp:
        raise ValueError(f"batch {x.shape[0]} not divisible by {mesh.cfg.data_axis}={dp}")
    n = x.shape[0] // dp
    return x[i * n:(i + 1) * n]


def replicated(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """`x` as global rank 0 holds it, on every rank (a broadcast, in
    place)."""
    if dist.get_world_size() > 1:
        dist.broadcast(x, src=0)
    return x


def gather_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The data axis's shards of a batch, concatenated back in rank order:
    the inverse of `batch_sharding`."""
    group = mesh.group(mesh.cfg.data_axis)
    n = group_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the gradient of each rank's input is the sum of
    every rank's output gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: the identity forward (the input is replicated over the
    group), the gradient summed over the group in f32."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g32 = g.to(torch.float32, copy=True)
        dist.all_reduce(g32, group=ctx.group)
        return g32.to(g.dtype), None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: partial sums reduced over the group, the gradient
    passed through (the output is replicated over the group)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over `group`; `x` itself when the group has one
    rank or is None."""
    return x if group_size(group) == 1 else _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Where a replicated tensor enters column-split products: identity,
    with its gradient summed over `group`."""
    return x if group_size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(partial: torch.Tensor, group) -> torch.Tensor:
    """The all-reduce after a row-split product: the partial sums added in
    f32 over `group` and cast back to the partial's dtype."""
    if group_size(group) == 1:
        return partial
    return _ReduceFromGroup.apply(partial.float(), group).to(partial.dtype)
