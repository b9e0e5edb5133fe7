"""Device selection for the port's entry points, and reproducible
gradients on the card.

Entry points run on the card unless the caller asks for the CPU with
`device="cpu"`. Without CUDA and without that request they raise: nothing
falls back to the CPU on its own.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for the block, the flag restored
    after. With the default ones the embedder's backward convolutions may
    sum in any order, so two identical gradient computations on the card
    need not agree bit for bit; the training step and the attribution
    harness take their gradients under this."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before
