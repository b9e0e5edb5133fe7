"""The program's spans (`xai_audio_deepfakes_tpu_torch/utils/profiling.py`)
as the benchmark reads them.

The program's recorder records while a torch.profiler runs in the process,
so the profiled stretch of a `--trace 1` run leaves the spans of its traced
units in the recorder, and a reader takes them from there after the run
(or from `window["spans"]` and `window["serve_records"]`, where a traffic
kind's run puts them). A program without the recorder gives none, and the reader's
metric is left out of the line.

`SpanTrace` is a `tracing.Trace` whose idle gaps are named also by span
intervals of any thread (epoch ns, placed on the trace's clock through its
`trace_start_ns()`): a gap is named by the innermost of the host operations
and those intervals at its midpoint. Its busy time, wall time and
operations are the `Trace`'s.
"""

from __future__ import annotations

import bisect
import math

from portbench import tracing


def _profiling():
    try:
        from xai_audio_deepfakes_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "records") else None


def program_spans(window: dict) -> dict | None:
    """{name: {"calls", "host_ms", "device_ms"}} of the traced stretch, or
    None."""
    if "spans" in window:
        return window["spans"]
    profiling = _profiling()
    return None if profiling is None else profiling.read()


def serve_records(window: dict) -> list | None:
    """The serving path's span records, (name, thread, start ns, end ns), or
    None."""
    if "serve_records" in window:
        return window["serve_records"]
    profiling = _profiling()
    return None if profiling is None else profiling.records("serve.")


def device_ms_per_unit(r, *names: str) -> float | None:
    """The device ms of the spans `names`, summed, over the traced stretch's
    units (explains or steps); None where a span is missing or has no
    device time."""
    spans = program_spans(r.window)
    if not spans or r.trace is None or not r.trace.units:
        return None
    total = 0.0
    for name in names:
        ms = spans.get(name, {}).get("device_ms")
        if ms is None:
            return None
        total += ms
    return total / r.trace.units


def percentile(values: list, q: float) -> float:
    """The value at rank ceil(q n) of the sorted values (as `serve_p95_ms`
    of `open_loop_http`)."""
    v = sorted(values)
    return v[min(len(v) - 1, max(0, math.ceil(q * len(v)) - 1))]


def requests(records: list) -> list:
    """Each served request's stamps (epoch ns): {"thread", "start" (handler
    start), "put", "get", "closed" (its batch's close), "explain_start",
    "explain_end", "reply" (written)}, from a `serve.request` and the
    `serve.queue` of its thread inside it, the `serve.linger` that holds its
    get and the `serve.explain` after that linger. A request whose stamps
    are not all recorded is left out."""
    by = {}
    for name, thread, s, e in records:
        by.setdefault(name, []).append((s, e, thread))
    lingers = sorted((s, e) for s, e, _ in by.get("serve.linger", []))
    explains = sorted((s, e) for s, e, _ in by.get("serve.explain", []))
    queued: dict = {}
    for s, e, thread in by.get("serve.queue", []):
        queued.setdefault(thread, []).append((s, e))
    out = []
    for start, reply, thread in sorted(by.get("serve.request", [])):
        put = [q for q in queued.get(thread, []) if start <= q[0] <= reply]
        if len(put) != 1:
            continue
        put, get = put[0]
        i = bisect.bisect_right(lingers, (get, math.inf)) - 1
        if i < 0 or not lingers[i][0] <= get <= lingers[i][1]:
            continue
        closed = lingers[i][1]
        j = bisect.bisect_left(explains, (closed, -math.inf))
        if j == len(explains) or explains[j][1] > reply:
            continue
        out.append({"thread": thread, "start": start, "put": put, "get": get,
                    "closed": closed, "explain_start": explains[j][0],
                    "explain_end": explains[j][1], "reply": reply})
    return out


def trace_start_ns(prof) -> int:
    """The epoch ns of the profiler's time zero."""
    return prof.profiler.kineto_results.trace_start_ns()


class SpanTrace(tracing.Trace):
    """A `Trace` with span intervals ((name, thread, start ns, end ns),
    epoch clock) among the names of its idle gaps."""

    def __init__(self, prof, wall_s: float, units: int, spans: list | None = None):
        super().__init__(prof, wall_s, units)
        t0 = trace_start_ns(prof)
        self.spans = [((s - t0) / 1e3, (e - t0) / 1e3, name) for name, _, s, e in spans or []]

    def _host_at(self, t: float) -> str:
        i = bisect.bisect_right(self._starts, t)
        hits = [h for h in reversed(self.host[max(0, i - 400):i]) if h[1] >= t]
        hits += [s for s in self.spans if s[0] <= t <= s[1]]
        return min(hits, key=lambda h: h[1] - h[0])[2] if hits else "host: no operation"
