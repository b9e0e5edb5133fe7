"""Checkpoints with resume (port of `train/checkpoints.py`, in a torch
format).

A checkpoint is one `torch.save` file that carries the FULL train state: the
decoder's state dict (parameters and BatchNorm running statistics), the raw
loss weights, both optimisers' state dicts and the step count. File names
keep the reference's epoch+loss encoding, `addvisor_epoch_{n}_loss_{x:.4f}.pt`.
Files are read back with `weights_only=True`, so loading runs no pickled
code.

A sharded state (the rank's blocks of a parameter tree under a mesh,
`parallel/sharding.py`) goes through `torch.distributed.checkpoint`
instead (`save_sharded_checkpoint` / `load_sharded_checkpoint`, one
directory written by every rank): each block is described as a `DTensor`
of the spec's placements, so the directory holds each global tensor once
and a load gives every rank its block back.

`save_checkpoint(..., async_save=True)` copies the state to the host before
it returns and leaves the write (`torch.save` to a `.tmp` file, then
`os.replace`) to one worker thread, so the file system overlaps the next
epoch's compute. `wait_for_saves()` blocks until every write has committed
and raises the first failure. A `HostSnapshot` is a state already copied
to the host in the device's stream order (the trainer takes one at an
epoch's end); it is written as it is, with no second copy.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
import threading

import torch

_NAME_RE = re.compile(r"addvisor_epoch_(\d+)_loss_([0-9.]+)\.pt$")

_writer: concurrent.futures.ThreadPoolExecutor | None = None
_pending: list[concurrent.futures.Future] = []
_lock = threading.Lock()


def checkpoint_name(epoch: int, loss: float) -> str:
    return f"addvisor_epoch_{epoch}_loss_{loss:.4f}.pt"


def _write(sd: dict, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(sd, tmp)
    os.replace(tmp, path)


def to_host(obj, non_blocking: bool = False):
    """`obj` (a state dict, nested dicts, lists and tuples) with every tensor
    copied to host memory of its own: a CPU tensor too, since a training
    step updates the state in place. A card's tensor goes to pinned memory,
    with `non_blocking` asynchronously in stream order (the caller records
    an event and waits for it before reading)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.device.type == "cpu":
            return t.clone()
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
            t, non_blocking=non_blocking)
    if isinstance(obj, dict):
        return {k: to_host(v, non_blocking) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v, non_blocking) for v in obj)
    return obj


def record_event(device: torch.device) -> "torch.cuda.Event | None":
    """An event recorded now on `device`'s current stream; None off the
    card, where every copy is done when it returns."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record()
    return event


class HostSnapshot:
    """A train state's state dict as it stood at one point of the device's
    stream: each tensor copied, in stream order, into host memory of its
    own (pinned on the card, the copy asynchronous), so that later in-place
    optimiser steps cannot reach it while a checkpoint writer reads it.
    `state_dict()` waits for the copy."""

    def __init__(self, state):
        self.step = state.step
        self._sd = to_host(state.state_dict(), non_blocking=True)
        self._ready = record_event(state.w_raw.device)

    def state_dict(self) -> dict:
        if self._ready is not None:
            self._ready.synchronize()
        return self._sd


def save_checkpoint(directory: str, epoch: int, loss: float, state,
                    async_save: bool = False) -> str:
    """Write `state` (an `AddvisorTrainState`, or anything with a
    `state_dict()`) under directory/addvisor_epoch_N_loss_X.pt, atomically,
    and return the path. With `async_save` the state is copied to the host
    now (a `HostSnapshot` is already) and written by a worker thread: call
    `wait_for_saves()` before reading the file back or exiting."""
    global _writer
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, checkpoint_name(epoch, loss)))
    if not async_save:
        _write(state.state_dict(), path)
        return path
    sd = state.state_dict() if isinstance(state, HostSnapshot) else to_host(state.state_dict())
    with _lock:
        if _writer is None:
            _writer = concurrent.futures.ThreadPoolExecutor(1, "checkpoint-writer")
        _pending.append(_writer.submit(_write, sd, path))
    return path


def wait_for_saves() -> None:
    """Block until every asynchronous write has committed; re-raise the
    first that failed."""
    with _lock:
        pending = list(_pending)
        _pending.clear()
    errors = [f.exception() for f in pending]
    for err in errors:
        if err is not None:
            raise err


def load_checkpoint(path: str, device="cpu") -> dict:
    """The saved dictionary, tensors mapped onto `device`."""
    return torch.load(path, map_location=device, weights_only=True)


def restore_checkpoint(path: str, state):
    """Load the checkpoint at `path` into `state`, in place; returns it."""
    state.load_state_dict(load_checkpoint(path, state.w_raw.device))
    return state


def latest_checkpoint(directory: str) -> str | None:
    """The checkpoint of the highest epoch in `directory`, or None."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = _NAME_RE.match(name)
        if m and (best is None or int(m.group(1)) > best[0]):
            best = (int(m.group(1)), name)
    return os.path.join(directory, best[1]) if best else None


def parse_checkpoint_name(path: str) -> tuple[int, float] | None:
    m = _NAME_RE.search(os.path.basename(os.path.normpath(path)))
    return (int(m.group(1)), float(m.group(2))) if m else None


def _placements(spec: tuple, mesh) -> list:
    from torch.distributed.tensor import Replicate, Shard

    dims = {axis: d for d, axis in enumerate(spec) if axis is not None}
    return [Shard(dims[axis]) if axis in dims else Replicate() for axis in mesh.axes]


def _as_dtensors(tree: dict, mesh, specs: dict | None) -> dict:
    from torch.distributed.tensor import DTensor

    from xai_audio_deepfakes_tpu_torch.parallel.sharding import tree_map_with_path, _leaves_with_path

    flat = dict(_leaves_with_path(specs)) if specs is not None else {}

    def wrap(path, leaf):
        t = torch.as_tensor(leaf)
        return DTensor.from_local(t, mesh.device_mesh, _placements(flat.get(path, ()), mesh),
                                  run_check=False)

    return tree_map_with_path(wrap, tree)


def save_sharded_checkpoint(directory: str, tree: dict, mesh, specs: dict | None = None) -> str:
    """Write the rank's blocks `tree` (nested dicts of tensors or arrays)
    under `specs` (the same structure, spec tuples; None: replicated) with
    `torch.distributed.checkpoint`. Every rank of the mesh calls it."""
    import torch.distributed.checkpoint as dcp

    os.makedirs(directory, exist_ok=True)
    dcp.save(_as_dtensors(tree, mesh, specs), checkpoint_id=directory)
    return os.path.abspath(directory)


def load_sharded_checkpoint(directory: str, like: dict, mesh, specs: dict | None = None) -> dict:
    """The rank's blocks read back from `save_sharded_checkpoint`'s
    directory, into new tensors shaped as `like`'s under the same specs."""
    import torch.distributed.checkpoint as dcp

    from xai_audio_deepfakes_tpu_torch.parallel.sharding import tree_map_with_path

    target = _as_dtensors(tree_map_with_path(lambda _, t: torch.empty_like(torch.as_tensor(t)),
                                             like), mesh, specs)
    dcp.load(target, checkpoint_id=directory)
    return tree_map_with_path(lambda _, d: d.to_local(), target)
