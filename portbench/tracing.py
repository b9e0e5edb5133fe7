"""What a `--trace 1` run reads from torch.profiler: device intervals and
the breakdown.

Busy time is the union of the intervals of every device operation (kernels,
copies, sets) over the traced stretch; the stretch's length is the host's
wall clock from its first dispatch to its last synchronisation. An idle gap
is a stretch between device operations; it is named by the innermost host
operation running at its midpoint (or "host: no operation").
"""

from __future__ import annotations

import bisect
import contextlib
import time

import torch

TOP = 10


def _device_events(events) -> list:
    seen, out = set(), []
    for ev in events:
        # an annotation's device-side twin spans the gaps between its kernels
        if not str(ev.device_type).endswith("CUDA") or getattr(ev, "is_user_annotation", False):
            continue
        key = (ev.name, ev.time_range.start, ev.time_range.end)
        if key not in seen:
            seen.add(key)
            out.append(key)
    return out


class Trace:
    """The reading of one profiled stretch."""

    def __init__(self, prof, wall_s: float, units: int):
        events = prof.events()
        self.units = units  # calls of the traced stretch
        self.wall_s = wall_s
        self.ops = _device_events(events)  # (name, start us, end us)
        merged = []  # the union of the operations' intervals
        for s, e in sorted((s, e) for _, s, e in self.ops):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) / 1e6
        self.gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
        self.host = [(ev.time_range.start, ev.time_range.end, ev.name) for ev in events
                     if not str(ev.device_type).endswith("CUDA")]
        self.host.sort()
        self._starts = [h[0] for h in self.host]

    def kernel_seconds(self, pattern) -> tuple[float, int]:
        """(device seconds, launches) of the operations whose name matches."""
        hits = [(e - s) for n, s, e in self.ops if pattern.search(n)]
        return sum(hits) / 1e6, len(hits)

    def _host_at(self, t: float) -> str:
        i = bisect.bisect_right(self._starts, t)
        best = None
        for s, e, name in reversed(self.host[max(0, i - 400):i]):
            if e >= t and (best is None or e - s < best[0]):
                best = (e - s, name)
        return best[1] if best else "host: no operation"

    def breakdown(self) -> dict:
        by_op: dict = {}
        for n, s, e in self.ops:
            by_op[n[:120]] = by_op.get(n[:120], 0.0) + (e - s) / 1e6
        by_gap: dict = {}
        for s, e in sorted(self.gaps, key=lambda g: g[0] - g[1])[:400]:
            name = self._host_at((s + e) / 2)[:120]
            by_gap[name] = by_gap.get(name, 0.0) + (e - s) / 1e6
        return {"device_ops": _top(by_op), "idle_gaps": _top(by_gap)}


def _top(seconds: dict) -> list:
    return sorted(([k, v] for k, v in seconds.items()), key=lambda kv: -kv[1])[:TOP]


@contextlib.contextmanager
def profiled(out: dict, cuda: bool = True):
    """Profile the block: CPU and (with `cuda`) CUDA activity, shapes off.
    `out["prof"]` and `out["wall_s"]` are set when it ends (after a
    synchronise)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with torch.profiler.profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        yield
        sync()
        out["wall_s"] = time.perf_counter() - t0
    out["prof"] = prof
