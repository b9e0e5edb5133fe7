"""Whole runs of a tiny cut of each cell on the CPU, the harness's look for
a card skipped: the result line and its keys, and `correct` coming out
false when the timed path is broken underneath (`faults.py`: half the batch
left out; an answer altered where it is produced; for training also a step
that leaves its state unchanged)."""

from __future__ import annotations

import json

import pytest

from portbench import faults, harness
from portbench.tests.tiny import SERVED, argv, tiny_files

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = tuple(w["name"] for w in BENCH["workloads"]) + (SERVED["name"],)
KIND = {w: tiny_files(SERVED if w == SERVED["name"] else w)[2]["kind"] for w in CELLS}
# batches of two (a long linger) and every reply compared, so that half of
# each batch left out reaches the comparison
SERVE = dict(rate_per_s=24.0, pool_clips=6, sample_replies=24, drain_s=30.0, trace_seconds=0.4,
             clients=16, batch_size=2, linger_ms=500.0)


def _cell(workload):
    return SERVED if workload == SERVED["name"] else workload


def _run(workload, trace=0, hook=None, seed=2**31 + 11):
    cell, cfg, traffic = tiny_files(_cell(workload))
    seconds = 0.2
    if KIND[workload] == "open_loop_http":
        traffic, seconds = dict(traffic, **SERVE), 1.0
    code, result = harness.execute(argv(_cell(workload), seed=seed, seconds=seconds, trace=trace),
                                   device="cpu", files=(cell, cfg, traffic), hook=hook)
    assert code == 0
    return json.loads(json.dumps(result, allow_nan=False))


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", (0, 1))
def test_result_line(workload, trace):
    res = _run(workload, trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 2 and res["failed"] == 0
    e2e, layer = harness.metrics_of(workload, BENCH)
    want = {m["name"] for m in (layer if trace else e2e)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
        assert all(m["value"] > 0 for m in res["metrics"].values())
    else:
        assert "breakdown" in res and {"busy_s", "window_s"} <= set(res["device"])
    cfg = tiny_files(_cell(workload))[1]
    assert set(res["checks"]) == set(cfg["limits"][KIND[workload]])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


CASES = [(w, name, fault) for w in CELLS
         for name, fault in (faults.TRAIN if KIND[w] == "train_steps" else faults.EXPLAIN).items()]


@pytest.mark.parametrize("workload,name,fault", CASES, ids=[f"{w}-{n}" for w, n, _ in CASES])
def test_a_broken_timed_path_is_not_correct(workload, name, fault):
    res = _run(workload, hook=fault)
    assert res["correct"] is False
    over = [n for n, c in res["checks"].items()
            if c["value"] == "inf" or c["value"] > c["limit"]]
    assert over, res["checks"]
