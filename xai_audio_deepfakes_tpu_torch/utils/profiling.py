"""Tracing and stage timing (port of the JAX package's `utils/profiling.py`).

`trace(log_dir)` records the block with `torch.profiler` (host and CUDA
activities) and writes a Chrome trace into `log_dir`; `StageTimer` sums the
host wall time of named stages, each stop synchronised with the device of
its outputs, so that the device work lands in the stage that queued it.
The JAX version synchronises by copying a tiny slice to the host, a
workaround for a remote TPU; here `torch.cuda.synchronize` is the barrier.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable

import torch


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def sync(tree: Any) -> Any:
    """Barrier: wait for the CUDA devices that hold the tensors of `tree`
    (a tensor, or nested tuples, lists and dicts of them); a CPU tensor
    needs none. Returns `tree`."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block; writes `log_dir/trace.json` (Chrome
    trace format: chrome://tracing or Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Accumulates wall-clock per named stage; each stop() syncs the stage's
    outputs so device work is attributed to the right stage."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def _add(self, name: str, dt: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def stage(self, name: str, outputs: Any = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if outputs is not None:
                sync(outputs)
            self._add(name, time.perf_counter() - t0)

    def timed(self, name: str, fn: Callable) -> Callable:
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = sync(fn(*a, **kw))
            self._add(name, time.perf_counter() - t0)
            return out

        return wrapped

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "calls": self.counts[name],
                "mean_ms": round(1000 * self.totals[name] / self.counts[name], 2),
            }
            for name in self.totals
        }
