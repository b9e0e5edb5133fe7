"""Backward passes of the kernel wrappers: recomputation in plain PyTorch.

The JAX package's `custom_vjp`s take every kernel's gradient through its
plain reference formulation, from the saved inputs, instead of through a
backward kernel. The port's `torch.autograd.Function`s do the same with the
helper here: the forward launches the hand-written kernel, the backward runs
autograd through the kernel's plain version.
"""

from __future__ import annotations

import torch


def needs_grad(*tensors) -> bool:
    """True when autograd would record an op on these inputs."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def recompute_vjp(plain, inputs, needs, grad_outputs):
    """Gradients of `plain(*inputs)` against `grad_outputs`, one per input,
    None where `needs` is false."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        out = plain(*ins)
        grads = iter(torch.autograd.grad(out, [t for t, n in zip(ins, needs) if n], grad_outputs))
    return tuple(next(grads) if n else None for n in needs)
