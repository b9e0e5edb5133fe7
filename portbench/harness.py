"""One run of one cell: find the cell, its configuration and its traffic by
name, check the card, run the traffic's driver, read the cell's metrics,
check that no JAX module was loaded, and print the result.

The cell is the `workloads` entry of `BENCHMARK.json` named by
`--workload`; its configuration is `configs/<config>.json`, its traffic
`traffic/<traffic>.json`, whose `kind` names the driver
(`drivers/<kind>.py`). With `--trace 0` the result's metrics are the cell's
end-to-end metrics; with `--trace 1` its per-layer metrics, each read by
`layer_metrics/<name>.py` (`read(reading) -> float | None`; None leaves the
metric out of the line).

Standard error ends with each compared number beside its limit; the last
line of standard output is the result, whose last key, `checks`, repeats
them.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from portbench import check

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "xai_audio_deepfakes_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot), whole, is
    JAX's, jaxlib's, flax's or the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(workload: str, benchmark: dict | None = None) -> tuple[dict, dict, dict]:
    """(the workloads entry, the configuration file, the traffic file)."""
    benchmark = load_json(ROOT / "BENCHMARK.json") if benchmark is None else benchmark
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    return (cell, load_json(HERE / "configs" / f"{cell['config']}.json"),
            load_json(HERE / "traffic" / f"{cell['traffic']}.json"))


def metrics_of(workload: str, benchmark: dict) -> tuple[list, list]:
    """The cell's end-to-end and per-layer metric entries."""
    e2e = [m for m in benchmark["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in benchmark["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def load_reader(name: str):
    path = HERE / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_layer_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What a driver gets: the run's arguments, the cell's files, the device
    and the few device services it uses (no-ops on the CPU)."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    cfg: dict
    traffic: dict
    device: str = "cuda"
    t_start: float = 0.0
    hook: object = lambda timed: timed  # wraps the timed path's callable (tests break it)

    @property
    def cuda(self) -> bool:
        return self.device == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def reset_peak(self) -> None:
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return int(torch.cuda.max_memory_allocated()) if self.cuda else 0

    def empty_cache(self) -> None:
        if self.cuda:
            torch.cuda.empty_cache()

    def since_start(self) -> float:
        return time.perf_counter() - self.t_start

    def smi(self) -> str:
        """The card's SM clock, power draw and temperature now (a diagnostic
        printed beside the window)."""
        if not self.cuda:
            return "no card"
        return device_line("clocks.sm,power.draw,temperature.gpu")

    def out_dir(self) -> Path:
        d = ROOT / "build" / "portbench" / self.workload
        d.mkdir(parents=True, exist_ok=True)
        return d

    def save_trace(self, prof) -> None:
        prof.export_chrome_trace(str(self.out_dir() / f"trace_seed{self.seed}.json.gz"))


@dataclasses.dataclass
class Reading:
    """What a per-layer reader gets."""

    trace: object
    window: dict
    cfg: dict  # the configuration's `pipeline`
    traffic: dict
    result: dict


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_line(fields: str = "name,power.limit") -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def execute(argv=None, t_start: float | None = None, device: str = "cuda", hook=None,
            files: tuple | None = None, detail: bool = False) -> tuple[int, dict | None]:
    """One run -> (exit code, result or None). `device="cpu"`, `files` (the
    cell's entry, configuration and traffic) and `hook` serve the
    CPU tests: a tiny cell, a broken timed path; `detail` adds the driver's
    window counts and compared numbers ("window", "numbers") to the result
    (the knee sweep and the limits' readings read them)."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    benchmark = load_json(ROOT / "BENCHMARK.json")
    cell, cfg, traffic = cell_files(args.workload, benchmark) if files is None else files
    if device == "cuda":
        want = int(cell["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < want:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: the cell needs {want} CUDA card(s), found {have}", file=sys.stderr)
            return 2, None
        print(f"device: {device_line()}", file=sys.stderr)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(args.workload, args.seed, args.seconds, bool(args.trace), cfg, traffic, device,
              t_start, hook or (lambda timed: timed))
    driver = importlib.import_module(f"portbench.drivers.{traffic['kind']}")
    res = driver.run(run)

    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3, None
    e2e, layer = metrics_of(args.workload, benchmark)
    metrics = {}
    if run.trace:
        reading = Reading(res["trace"], res["window"], cfg["pipeline"], traffic, res)
        for m in layer:
            value = load_reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": float(res["end_to_end"][m["name"]]), "unit": m["unit"]}
    correct, checks = check.verdict(res["numbers"], cfg["limits"].get(traffic["kind"], {}))
    dev = {"platform": "gpu" if run.cuda else device,
           "kind": torch.cuda.get_device_name(0) if run.cuda else device,
           "count": int(cell["chips"]), "memory_peak_bytes": res["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
              "metrics": metrics, "device": dev}
    if run.trace and res["trace"] is not None:
        dev["busy_s"], dev["window_s"] = res["trace"].busy_s, res["trace"].wall_s
        result["breakdown"] = res["trace"].breakdown()
    if detail:
        result["window"], result["numbers"] = res["window"], res["numbers"]
    result["checks"] = checks
    print(f"launches per call: {json.dumps(res.get('launches_per_explain', {}))}", file=sys.stderr)
    print(f"memory_peak_bytes: {res['memory_peak_bytes']}", file=sys.stderr)
    for extra in res.get("log", []):
        print(extra, file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    return 0, result


def main(argv=None, t_start: float | None = None) -> int:
    code, result = execute(argv, t_start)
    if result is not None:
        print(json.dumps(result, allow_nan=False))
    return code
