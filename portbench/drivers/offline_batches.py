"""Offline explain: `explain(decoder="unet")` dispatched back to back over a
pool of distinct seeded batches, each batch's outputs copied to the host
once, as the CLI's `explain` and `eval` copy them.

Set-up: the pipeline, the weights (drawn, calibrated, set into it, then
kept on the host), the pool, and `warm_batches` explains of the pool's first
batches. The window: explains until `seconds` have passed; the rate is the
clips whose outputs reached the host over the time from the window's start
to the last copy. For each pool batch one dispatch's host outputs, drawn
from the seed (a reservoir of one), are kept for the comparison. With
`--trace 1`, `trace_batches` more explains run under the profiler.

After the window and the peak's reading the pipeline is freed and the plain
reference explains every pool batch from the same clips and weights.
"""

from __future__ import annotations

import gc
import random
import time

from portbench import tracing, weights
from portbench.cellkit import (
    host_copy,
    make_pool,
    pipeline_config,
    prepared_weights,
    reference_numbers,
)


def run(run) -> dict:
    """`run`: the harness's `Run` (seed, seconds, trace, device, the cell's
    configuration and traffic, `hook`)."""
    from xai_audio_deepfakes_tpu_torch.ops import _cuda
    from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline

    cfg, traffic, dev = run.cfg["pipeline"], run.traffic, run.device
    b, n_pool = traffic["batch"], traffic["pool_batches"]
    marks = [("start", run.since_start())]

    pipe = ADDvisorPipeline(pipeline_config(cfg), device=dev, seed=0)
    marks.append(("pipeline", run.since_start()))
    w = prepared_weights(run.cfg, traffic, run.seed, dev)
    marks.append(("weights", run.since_start()))
    weights.load_into(pipe, w)
    w = weights.to(w, "cpu")
    pool = make_pool(cfg, traffic, run.seed, dev)
    marks.append(("load, pool", run.since_start()))
    explain = run.hook(lambda wav: pipe.explain(wav, decoder="unet"))
    run.sync()
    run.reset_peak()
    for i in range(traffic["warm_batches"]):
        host_copy(explain(pool[i % n_pool]))
        marks.append((f"warm {i + 1}", run.since_start()))
    run.sync()
    _cuda.reset_launches()
    setup_s = run.since_start()

    rng = random.Random(run.seed)
    kept, seen = [None] * n_pool, [0] * n_pool
    dispatched, times = 0, []
    smi_before = run.smi()
    t0 = time.perf_counter()
    while True:
        slot = dispatched % n_pool
        host = host_copy(explain(pool[slot]))
        dispatched += 1
        times.append(time.perf_counter())
        seen[slot] += 1
        if rng.random() * seen[slot] < 1.0:
            kept[slot] = host
        elapsed = time.perf_counter() - t0
        if elapsed >= run.seconds and dispatched >= n_pool:
            break
    launches = {k: v / dispatched for k, v in _cuda.LAUNCHES.items()}
    smi_after = run.smi()
    per = sorted(end - start for start, end in zip([t0] + times, times))

    trace = None
    if run.trace:
        got: dict = {}
        k = traffic["trace_batches"]
        with tracing.profiled(got, run.cuda):
            for i in range(k):
                host_copy(explain(pool[(dispatched + i) % n_pool]))
        trace = tracing.Trace(got["prof"], got["wall_s"], k)
        run.save_trace(got["prof"])
    peak = run.peak()

    del pipe, explain
    gc.collect()
    run.empty_cache()
    t_ref = time.perf_counter()
    numbers = reference_numbers(weights.to(w, dev), pool, kept, cfg)
    log = ["set-up marks (s since start): " + ", ".join(f"{k} {v:.3f}" for k, v in marks),
           f"reference: {time.perf_counter() - t_ref:.3f} s; window {elapsed:.3f} s, "
           f"{dispatched} explains, each {per[0]:.4f} / {per[len(per) // 2]:.4f} / "
           f"{per[-1]:.4f} s (least / median / most)",
           f"card (sm clock, power, temperature) before the window: {smi_before}; after: {smi_after}"]
    return {
        "attempted": dispatched * b,
        "failed": 0,
        "end_to_end": {"explain_clips_per_s": dispatched * b / elapsed, "setup_s": setup_s},
        "window": {"units": dispatched, "clips": dispatched * b, "seconds": elapsed,
                   "batch": b},
        "trace": trace,
        "launches_per_explain": launches,
        "memory_peak_bytes": peak,
        "numbers": numbers,
        "log": log,
    }
