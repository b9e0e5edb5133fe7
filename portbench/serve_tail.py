"""Where the live API's tail goes: the served traffic (`entry-serve`, which
BENCHMARK.json leaves out: `xlsr2b-l9-entry` under
`traffic/serve_poisson.json`) at fixed rates, one run after another in this
process, with the program's spans recorded through each whole run:

    python3 portbench/serve_tail.py --rates 20 40 --seeds 11 12 13 [--seconds 30] [--trace 1]

Per run it prints one JSON line: the load generator's latencies (p50, p95,
p99 and the most) from each request's due time and from its send; the same
of the requests' time inside the program (`serve.request`: handler start
to reply written) and of their wait before their batch ran (put to the
batch's close); the p95 of each `serve.*` span; the requests waiting when
a batch started (`serve.queue_depth`); with `--trace 1` the traced
seconds' busy share and idle gaps, named by the spans of every thread
(`spans.SpanTrace`). Each request's server-side stamps (epoch ns) are
written beside the generator's records (seconds from its start) to
`build/portbench/entry-serve/stamps_rate<R>_seed<N>_trace<T>.json`. With
`--spans 0` (and `--trace 0`) nothing is recorded: the generator's numbers
under the benchmark's own conditions, to set against a recorded run.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness, spans, tracing  # noqa: E402

CELL = {"name": "entry-serve", "config": "xlsr2b-l9-entry", "traffic": "serve_poisson",
        "chips": 1}
QS = (0.5, 0.95, 0.99, 1.0)


def quantiles(values: list) -> dict | None:
    return {f"p{round(100 * q)}": spans.percentile(values, q) for q in QS} if values else None


class Collector:
    """Copies the recorder's serving records every `every_s` seconds, so that
    none is lost from its bounded ring over a long window."""

    def __init__(self, profiling, every_s: float = 0.5):
        self.profiling, self.every_s = profiling, every_s
        self.seen: set = set()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.wait(self.every_s):
            self.seen.update(self.profiling.records("serve."))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)
        self.seen.update(self.profiling.records("serve."))
        return False


def one_run(rate: float, seed: int, seconds: float, trace: bool, device: str = "cuda",
            files: tuple | None = None, record: bool = True) -> dict:
    from xai_audio_deepfakes_tpu_torch.utils import profiling

    cell, cfg, traffic = files or (
        CELL, harness.load_json(harness.HERE / "configs" / f"{CELL['config']}.json"),
        harness.load_json(harness.HERE / "traffic" / f"{CELL['traffic']}.json"))
    plain_trace = tracing.Trace
    # `open_loop_http` builds its trace through this name: name its gaps by the spans
    tracing.Trace = lambda prof, wall_s, units: spans.SpanTrace(prof, wall_s, units,
                                                                profiling.records())
    profiling.reset()
    if record:
        profiling.on()
    try:
        with Collector(profiling) as got:
            code, res = harness.execute(
                ["--workload", cell["name"], "--seed", str(seed), "--seconds", str(seconds),
                 "--trace", str(int(trace))],
                device=device, files=(cell, cfg, dict(traffic, rate_per_s=rate)), detail=True)
    finally:
        profiling.off()
        tracing.Trace = plain_trace
    if code != 0:
        raise RuntimeError(f"the served run failed ({code})")
    records = sorted(got.seen, key=lambda r: r[2])
    out_dir = harness.ROOT / "build" / "portbench" / cell["name"]
    load = json.loads((out_dir / f"load_seed{seed}.json").read_text())
    gen = [{k: r[k] for k in ("clip", "due", "sent", "done", "status")}
           for r in load["records"] if r is not None]
    ok = [r for r in gen if r["status"] == 200]
    reqs = spans.requests(records)
    if record:
        (out_dir / f"stamps_rate{rate:g}_seed{seed}_trace{int(trace)}.json").write_text(
            json.dumps({"rate_per_s": rate, "seed": seed, "generator": gen, "server": reqs}))
    by_span: dict = {}
    for name, _, s, e in records:
        by_span.setdefault(name, []).append((e - s) / 1e6)
    depth = profiling.counters().get("serve.queue_depth")
    line = {
        "rate_per_s": rate, "seed": seed, "correct": res["correct"], "failed": res["failed"],
        "requests": len(gen), "server_requests": len(by_span.get("serve.request", [])),
        "joined": len(reqs),
        "generator_from_due_ms": quantiles([1e3 * (r["done"] - r["due"]) for r in ok]),
        "generator_from_send_ms": quantiles([1e3 * (r["done"] - r["sent"]) for r in ok]),
        "in_program_ms": quantiles(by_span.get("serve.request", [])),
        "queue_wait_ms": quantiles([(q["closed"] - q["put"]) / 1e6 for q in reqs]),
        "span_p95_ms": {k: spans.percentile(v, 0.95) for k, v in sorted(by_span.items())},
        "queue_depth": depth and {"max": depth["max"], "mean": depth["sum"] / depth["calls"]},
        "rows_per_batch": res["window"]["rows"] / max(res["window"]["batches"], 1),
        "outstanding_at_end": res["window"]["outstanding_at_end"],
    }
    if trace:
        line["busy_s"], line["window_s"] = res["device"]["busy_s"], res["device"]["window_s"]
        line["idle_gaps"] = res["breakdown"]["idle_gaps"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    if args.trace and not args.spans:
        ap.error("a traced run records the spans (the profiler turns the recorder on)")
    for rate in args.rates:
        for seed in args.seeds:
            print(json.dumps(one_run(rate, seed, args.seconds, bool(args.trace),
                                     record=bool(args.spans))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
