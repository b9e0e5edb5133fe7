"""The live API's knee: one cell's open-loop traffic at several fixed
rates, one after another in this process, each with its own server and
load generator:

    python3 portbench/sweep.py --workload entry-serve --seconds 15 --rates 20 30 40

Prints, per rate, the p50 and p95 from due time, the requests still
outstanding when the arrivals ended (a backlog that grows with the window
is a rate above the knee) and the generator's lateness."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=2**31 + 17)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell, cfg, traffic = harness.cell_files(args.workload)
    rows = []
    for rate in args.rates:
        code, res = harness.execute(
            ["--workload", args.workload, "--seed", str(args.seed), "--seconds",
             str(args.seconds), "--trace", "0"],
            files=(cell, cfg, dict(traffic, rate_per_s=rate)), detail=True)
        w = res["window"]
        rows.append({"rate_per_s": rate, "p95_ms": res["metrics"]["serve_p95_ms"]["value"],
                     "p50_ms": w["latency_p50_ms"], "outstanding_at_end": w["outstanding_at_end"],
                     "rows_per_batch": w["rows"] / max(w["batches"], 1), "failed": res["failed"],
                     "correct": res["correct"]})
        print(json.dumps(rows[-1]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
