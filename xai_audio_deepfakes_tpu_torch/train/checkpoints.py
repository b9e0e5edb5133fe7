"""Checkpoints with resume (port of `train/checkpoints.py`, in a torch
format).

A checkpoint is one `torch.save` file that carries the FULL train state: the
decoder's state dict (parameters and BatchNorm running statistics), the raw
loss weights, both optimisers' state dicts and the step count. File names
keep the reference's epoch+loss encoding, `addvisor_epoch_{n}_loss_{x:.4f}.pt`.
Files are read back with `weights_only=True`, so loading runs no pickled
code.
"""

from __future__ import annotations

import os
import re

import torch

_NAME_RE = re.compile(r"addvisor_epoch_(\d+)_loss_([0-9.]+)\.pt$")


def checkpoint_name(epoch: int, loss: float) -> str:
    return f"addvisor_epoch_{epoch}_loss_{loss:.4f}.pt"


def save_checkpoint(directory: str, epoch: int, loss: float, state) -> str:
    """Write `state` (an `AddvisorTrainState`) under
    directory/addvisor_epoch_N_loss_X.pt, atomically, and return the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, checkpoint_name(epoch, loss)))
    tmp = path + ".tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)
    return path


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
