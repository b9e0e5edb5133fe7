"""Tracing and the program's spans (port of the JAX package's
`utils/profiling.py`).

`trace(log_dir)` records the block with `torch.profiler` (host and CUDA
activities) and writes a Chrome trace into `log_dir`.

`span(name)` marks one stage of the program, named `<layer>.<stage>`
(`explain.embed`, `int8.rescale`, `serve.queue`, ...). The recorder is
process-wide and records between `on()` and `off()`, and while a
torch.profiler runs in the process, as `record_function` records only then
(so a profiled stretch, such as a benchmark's traced run, holds its spans);
otherwise `span` returns one shared no-op context after a flag test. A
recorded span
  * stamps its host interval with `time.time_ns()`, the epoch clock on
    which the profiler's events lie (`trace_start_ns()` plus an event's
    `time_range`), and its thread's id;
  * opens `torch.profiler.record_function(name)`, so that on the
    profiler's thread it names the host lane and the idle gaps inside it;
  * with `device` (the default) and CUDA in use, records a timing
    `torch.cuda.Event` on the current stream at entry and at exit. Nothing
    synchronises until `read()`.
`read()` synchronises once and returns {name: {"calls", "host_ms",
"device_ms"}}: `device_ms` sums the events' `elapsed_time` over the calls
(None where no call recorded events, as on the CPU); nested spans each keep
their own totals. `records(prefix)` gives the last `RING` calls as
(name, thread, start_ns, end_ns). `interval` records a host interval that
began elsewhere (a request queued on one thread and taken on another);
`count(name, n)` keeps a counter's calls, sum and maximum (`counters()`).
`paused()` keeps the block unrecorded on its thread: code that is traced
into a graph (`torch.export`) or run again by autograd (checkpointed layers)
runs in it.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time

import torch

RING = 4096  # per-call intervals kept for `records`
_FOLD_AT = 1024  # unread device intervals before finished ones are summed

# its `_is_profiler_enabled` is the flag torch.profiler sets while it runs
_PROFILER = torch.autograd.profiler
_NOOP = contextlib.nullcontext()


class _Recorder:
    def __init__(self):
        self.on = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._spans: dict = {}  # name -> [calls, host ns, device ms or None]
            self._pending: collections.deque = collections.deque()  # (name, start ev, end ev)
            self._ring: collections.deque = collections.deque(maxlen=RING)
            self._counters: dict = {}  # name -> [calls, sum, max]

    def paused_here(self) -> bool:
        return getattr(self._local, "paused", 0) > 0

    def add(self, name: str, thread: int, t0: int, t1: int, ev0=None, ev1=None) -> None:
        with self._lock:
            s = self._spans.setdefault(name, [0, 0, None])
            s[0] += 1
            s[1] += t1 - t0
            self._ring.append((name, thread, t0, t1))
            if ev0 is not None:
                self._pending.append((name, ev0, ev1))
                if len(self._pending) > _FOLD_AT:
                    self._fold(wait=False)

    def _fold(self, wait: bool) -> None:
        """Sum the device time of the pending intervals, oldest first; without
        `wait`, stop at the first whose end has not been reached."""
        while self._pending:
            name, ev0, ev1 = self._pending[0]
            if not wait and not ev1.query():
                return
            self._pending.popleft()
            s = self._spans[name]
            s[2] = (s[2] or 0.0) + ev0.elapsed_time(ev1)

    def read(self) -> dict:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        with self._lock:
            self._fold(wait=True)
            return {name: {"calls": c, "host_ms": ns / 1e6, "device_ms": d}
                    for name, (c, ns, d) in self._spans.items()}

    def records(self, prefix: str) -> list:
        with self._lock:
            return [r for r in self._ring if r[0].startswith(prefix)]

    def count(self, name: str, n: float) -> None:
        with self._lock:
            c = self._counters.setdefault(name, [0, 0, n])
            c[0] += 1
            c[1] += n
            c[2] = max(c[2], n)

    def counters(self) -> dict:
        with self._lock:
            return {name: {"calls": c, "sum": s, "max": m}
                    for name, (c, s, m) in self._counters.items()}


_REC = _Recorder()


class _Span:
    __slots__ = ("name", "device", "t0", "ev0", "rf")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        self.t0 = time.time_ns()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.ev0 = None
        if self.device and torch.cuda.is_initialized():
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        return self

    def __exit__(self, *exc):
        ev1 = None
        if self.ev0 is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
        self.rf.__exit__(*exc)
        _REC.add(self.name, threading.get_ident(), self.t0, time.time_ns(), self.ev0, ev1)
        return False


def _recording() -> bool:
    """Whether spans record now (on this thread)."""
    return (_REC.on or _PROFILER._is_profiler_enabled) and not _REC.paused_here()


def span(name: str, device: bool = True):
    """A context manager over one stage named `name`; `device=False` for a
    stage that queues no device work (a thread that never drives the card)."""
    if not (_REC.on or _PROFILER._is_profiler_enabled) or _REC.paused_here():
        return _NOOP
    return _Span(name, device)


def interval(name: str, start_ns: int, thread: int | None = None) -> None:
    """Record a host interval from `start_ns` (`time.time_ns()`, taken where
    it began) to now, under the id of the thread that began it."""
    if _recording():
        _REC.add(name, threading.get_ident() if thread is None else thread, start_ns,
                 time.time_ns())


def count(name: str, n: float) -> None:
    """Add `n` to the counter `name` (calls, sum, maximum)."""
    if _recording():
        _REC.count(name, n)


def on() -> None:
    _REC.on = True


def off() -> None:
    _REC.on = False


def reset() -> None:
    _REC.reset()


def read() -> dict:
    return _REC.read()


def records(prefix: str = "") -> list:
    return _REC.records(prefix)


def counters() -> dict:
    return _REC.counters()


@contextlib.contextmanager
def paused():
    """No span records inside the block on this thread."""
    local = _REC._local
    local.paused = getattr(local, "paused", 0) + 1
    try:
        yield
    finally:
        local.paused -= 1


def unrecorded(fn):
    """`fn` run under `paused()` at every call."""
    def wrapped(*args, **kwargs):
        with paused():
            return fn(*args, **kwargs)

    return wrapped


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
