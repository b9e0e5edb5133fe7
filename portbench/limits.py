"""The readings a cell's limits are set from, in one process on the card:

    python3 portbench/limits.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 7 8 9 [--fault-seeds 4 5 6] [--out FILE]

Lower readings, for each of `--seeds` (the largest over them counts):
  offline: the seed's weights set into one pipeline, its pool explained at
    the cell's batch through the timed path's entry, every pool batch
    compared with the plain reference;
  served: a run of the cell with a `--serve-seconds` window at its own rate,
    its sampled replies compared as a run compares them;
  training: a fresh training state over the seed's weights, its first
    checked steps through the window's step, against the reference's.
Upper readings, for each of `--control-seeds` (the smallest counts): the
reference computed one precision step lower (`control=True`) in the
program's place, against the reference as stated, on the same inputs (a
served cell's first `sample_replies` pool clips, through the reply the
service would make). A training cell also reads each fault of
`faults.TRAIN` planted in the program, on `--fault-seeds`. The benchmark's
own runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import cellkit, check, faults, harness, weights  # noqa: E402
from portbench.drivers import open_loop_http as http  # noqa: E402
from portbench.drivers import train_steps  # noqa: E402
from portbench.reference import explain as ref_explain  # noqa: E402

NUMBERS = {"offline_batches": check.EXPLAIN_NUMBERS, "open_loop_http": check.SERVE_NUMBERS,
           "train_steps": check.TRAIN_NUMBERS}


def make_pipeline(cfg: dict):
    from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline

    return ADDvisorPipeline(cellkit.pipeline_config(cfg), device="cuda", seed=0)


def program_offline(seed: int, pipe, cfg_file: dict, traffic: dict) -> dict:
    cfg = cfg_file["pipeline"]
    w = cellkit.prepared_weights(cfg_file, traffic, seed, "cuda")
    weights.load_into(pipe, w)
    pool = cellkit.make_pool(cfg, traffic, seed, "cuda")
    kept = [cellkit.host_copy(pipe.explain(pool[i], decoder="unet"))
            for i in range(pool.shape[0])]
    torch.cuda.empty_cache()
    numbers = cellkit.reference_numbers(w, pool, kept, cfg)
    probs = [float(v) for k in kept for v in k["probs_clean"].ravel()]
    return dict(numbers, probs_min=min(probs), probs_max=max(probs))


def program_train(seed: int, pipe, cfg_file: dict, traffic: dict, fault=None) -> dict:
    from xai_audio_deepfakes_tpu_torch.train.train_addvisor import (
        init_train_state,
        make_train_step,
    )

    cfg = cfg_file["pipeline"]
    w = cellkit.prepared_weights(cfg_file, traffic, seed, "cuda")
    weights.load_into(pipe, w)
    pool = cellkit.make_pool(cfg, traffic, seed, "cuda")
    state = init_train_state(pipe)
    step = make_train_step(pipe)
    step = fault(step) if fault else step
    prog = train_steps.first_steps(step, state, pool, traffic["checked_steps"])
    del state, step
    torch.cuda.empty_cache()
    ref = train_steps.reference_readings(w, pool, cfg, traffic["checked_steps"])
    return train_steps.compare(prog, ref)


def control(seed: int, cfg_file: dict, traffic: dict) -> dict:
    cfg, kind = cfg_file["pipeline"], traffic["kind"]
    w = cellkit.prepared_weights(cfg_file, traffic, seed, "cuda")
    if kind == "train_steps":
        pool = cellkit.make_pool(cfg, traffic, seed, "cuda")
        steps = traffic["checked_steps"]
        lower = train_steps.reference_readings(w, pool, cfg, steps, control=True)
        return train_steps.compare(lower, train_steps.reference_readings(w, pool, cfg, steps))
    served = kind == "open_loop_http"
    if served:
        pool = cellkit.make_pool(cfg, dict(traffic, batch=traffic["sample_replies"],
                                           pool_batches=1), seed, "cuda")
        pool = torch.from_numpy(http.pcm16(pool.cpu().numpy()).astype("float32") / 32768.0)
        pool = pool.to("cuda")
    else:
        pool = cellkit.make_pool(cfg, traffic, seed, "cuda")
    sr = cfg["audio"]["sample_rate"]
    numbers: dict = {}
    with torch.no_grad(), ref_explain.precise():
        for i in range(pool.shape[0]):
            stated = ref_explain.explain(w, pool[i], cfg, with_magnitude=served)
            lower = ref_explain.explain(w, pool[i], cfg, control=True, with_magnitude=served)
            if served:
                host = lambda d: {k: v.float().cpu().numpy() for k, v in d.items()}  # noqa: E731
                stated, lower = host(stated), host(lower)
                for j in range(len(stated["mask"])):
                    numbers = check.merge(numbers, http.reply_numbers(
                        http.reply_of(lower, j, sr), http.reply_of(stated, j, sr)))
            else:
                numbers = check.merge(numbers, check.explain_numbers(lower, stated))
            del stated, lower
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--serve-seconds", type=float, default=4.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell, cfg_file, traffic = harness.cell_files(args.workload)
    kind = traffic["kind"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"workload": args.workload, "device": harness.device_line(), "program": {},
           "control": {}, "faults": {}}

    def note(side, key, numbers, t0):
        out[side][key] = dict(numbers, s=time.perf_counter() - t0)
        print(f"{side} {key}: {out[side][key]}", flush=True)

    pipe = make_pipeline(cfg_file["pipeline"]) if kind != "open_loop_http" else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        if kind == "open_loop_http":
            _, res = harness.execute(["--workload", args.workload, "--seed", str(seed),
                                      "--seconds", str(args.serve_seconds), "--trace", "0"],
                                     files=(cell, cfg_file, traffic), detail=True)
            numbers = dict(res["numbers"], failed=res["failed"])
        elif kind == "train_steps":
            numbers = program_train(seed, pipe, cfg_file, traffic)
        else:
            numbers = program_offline(seed, pipe, cfg_file, traffic)
        note("program", seed, numbers, t0)
        gc.collect()
    if kind == "train_steps":
        for name, fault in faults.TRAIN.items():
            for seed in args.fault_seeds:
                t0 = time.perf_counter()
                numbers = program_train(seed, pipe, cfg_file, traffic, fault)
                note("faults", f"{name} {seed}", numbers, t0)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        note("control", seed, control(seed, cfg_file, traffic), t0)
        gc.collect()
    for side, pick in (("program", max), ("control", min), ("faults", min)):
        rows = list(out[side].values())
        if rows:
            out[side + "_reading"] = {k: pick(r[k] for r in rows) for k in NUMBERS[kind]}
    print(json.dumps({k: out.get(k) for k in ("program_reading", "control_reading",
                                              "faults_reading")}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
