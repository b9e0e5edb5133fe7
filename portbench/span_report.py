"""One run of a cell with the program's spans, for reading where its time
goes (and what the spans cost):

    python3 portbench/span_report.py --workload entry-offline --seed N [--seconds 30]
    python3 portbench/span_report.py --workload entry-offline --seed N --cost

By default the run is traced (`--trace 1`): it prints one JSON object with
the result line's per-layer metrics, the traced stretch's busy and wall
seconds a unit (explain or step), every span's calls, host ms and device ms
a unit, and the top-level spans' device ms a unit (`explain.*`, or
`train.*`) against the busy seconds. With `--cost` the run is untraced and
the recorder is on through all of it: the result line's end-to-end metrics,
to set against `run.py --trace 0` on the same seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402

TOP = ("explain.", "train.")


def main(argv=None) -> int:
    from xai_audio_deepfakes_tpu_torch.utils import profiling

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--cost", action="store_true")
    args = ap.parse_args(argv)
    run = ["--workload", args.workload, "--seed", str(args.seed), "--seconds", str(args.seconds),
           "--trace", str(int(not args.cost))]
    profiling.reset()
    if args.cost:
        profiling.on()
    try:
        code, res = harness.execute(run, detail=True)
    finally:
        profiling.off()
    if res is None:
        return code
    out = {"workload": args.workload, "seed": args.seed, "correct": res["correct"],
           "metrics": {k: v["value"] for k, v in res["metrics"].items()},
           "device": res["device"]}
    if not args.cost:
        traffic = harness.cell_files(args.workload)[2]
        units = traffic.get("trace_batches") or traffic["trace_steps"]
        spans = profiling.read()
        per = {name: {k: (v / units if v is not None else None) for k, v in s.items()}
               for name, s in sorted(spans.items())}
        top = [s["device_ms"] for name, s in per.items()
               if name.startswith(TOP) and s["device_ms"] is not None]
        busy_ms = 1e3 * res["device"]["busy_s"] / units
        out.update(units=units, busy_ms_per_unit=busy_ms,
                   wall_ms_per_unit=1e3 * res["device"]["window_s"] / units,
                   spans_per_unit=per, top_device_ms_per_unit=sum(top),
                   top_over_busy=sum(top) / busy_ms if busy_ms else None,
                   idle_gaps=res["breakdown"]["idle_gaps"])
    print(json.dumps(out))
    return code


if __name__ == "__main__":
    sys.exit(main())
