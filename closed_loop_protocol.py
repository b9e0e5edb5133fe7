#!/usr/bin/env python3
"""Run the anyband closed-loop protocol with the PyTorch/CUDA port on one
NVIDIA card and print its result.

    python3 closed_loop_protocol.py [--seed 0] [--f32-embedder] [--out PATH]

The protocol is the command line behind the JAX package's
`docs/closed_loop_anyband` result (`cli closed-loop --anyband --scan-layers
--remat --remat-policy dots --dtype bfloat16 --batch-size 16 --n-train 128
--n-eval 64 --epochs 120`, its noise rms 1.0 and decoder lr 3e-4), in
`closed_loop.anyband_protocol_config()`: a band-swap corpus whose artifact
band is drawn per clip, the LogReg detector fitted on its embeddings, the
UNet mask decoder trained against that detector, and the masks scored
against each clip's band. The weights are random, from the seed; the sizes
are fixed (the CLI's `closed-loop` will take them as options).
`--f32-embedder` runs the control: the same protocol with the embedder in
f32 and remat off (`scan_layers` is a parameter layout and stays), which
takes the bf16 and "dots" gradient path out of the loop.

It prints the card's name and power limit, each epoch's record as it is
finalised, and last one JSON line: the detector's accuracy and EER, its
fit (corpus rows and features, training rows, L-BFGS steps and seconds,
|w| and the median |logit| on its training rows), the before / after /
after-train localisation, keep and flip rates and LMAC
metrics, the steady epoch seconds and clips/s through the epoch loop, and
the phases' seconds. `--out` also writes that JSON and the training log.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

N_TRAIN, N_EVAL, EPOCHS, BATCH_SIZE, NOISE_RMS = 128, 64, 120, 16, 1.0


def float64_fit(torch, x, y, max_iter: int, device="cuda"):
    """The detector's objective on (x, y) fitted in float64 by the port's
    L-BFGS (tol 1e-12), to see how far an f32 fit is from the optimum.
    -> (steps, last gradient norm, weights [D], bias, the objective at any
    (w, b) in float64)."""
    import numpy as np

    from xai_audio_deepfakes_tpu_torch.train import train_logreg

    f64 = dict(dtype=torch.float64, device=device)
    xt = torch.as_tensor(x, **f64)
    yt = torch.as_tensor(y, **f64)[:, None]
    ref = {"weight": torch.zeros((x.shape[1], 1), **f64, requires_grad=True),
           "bias": torch.zeros((1,), **f64, requires_grad=True)}
    steps, _, _, gnorm = train_logreg.lbfgs_fit(
        lambda: train_logreg.logreg_objective(ref, xt, yt, 1e6), ref, max_iter, 1e-12)

    def objective(w, b) -> float:
        p = {"weight": torch.as_tensor(np.asarray(w, np.float64)[:, None], **f64),
             "bias": torch.tensor([float(b)], **f64)}
        with torch.no_grad():
            return float(train_logreg.logreg_objective(p, xt, yt, 1e6))

    return (steps, gnorm, ref["weight"].detach().cpu().numpy()[:, 0], float(ref["bias"][0]),
            objective)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--f32-embedder", action="store_true",
                    help="the control: embedder in f32, remat off")
    ap.add_argument("--out", default=None, help="write the result JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("closed_loop_protocol: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from xai_audio_deepfakes_tpu_torch.train import closed_loop, train_logreg

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cfg = closed_loop.anyband_protocol_config()
    if args.f32_embedder:
        cfg = cfg.replace(embedder=dataclasses.replace(cfg.embedder, dtype="float32",
                                                       remat=False))
    phases: dict = {}
    log: list = []

    def log_fn(rec: dict) -> None:
        log.append(rec)
        if "epoch" in rec:
            phases.setdefault("first_epoch_record", time.perf_counter())
        print(json.dumps(rec), flush=True)

    def timed(name, fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            phases[name] = phases.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapped

    for name in ("make_anyband_corpus", "detector_corpus_anyband", "train_detector",
                 "evaluate_explanations", "train_addvisor"):
        setattr(closed_loop, name, timed(name, getattr(closed_loop, name)))
    fit: dict = {}
    train_detector = closed_loop.train_detector

    def recorded_train_detector(x, y, **kw):
        params, metrics = train_detector(x, y, **kw)
        x_tr, _, y_tr, _ = train_logreg.stratified_split(x, y)
        w = params["weight"].cpu().numpy()[:, 0].astype(np.float64)
        z = x_tr.astype(np.float64) @ w + float(params["bias"].cpu()[0])
        fit.update(rows=int(x.shape[0]), features=int(x.shape[1]), train_rows=int(len(x_tr)),
                   w_norm=float(np.linalg.norm(w)),
                   median_abs_logit_train=float(np.median(np.abs(z))))
        t0 = time.perf_counter()
        steps, gnorm, w64, b64, objective = float64_fit(torch, x_tr, y_tr, 5000,
                                                        params["weight"].device)
        best = objective(w64, b64)
        fit["float64_reference"] = {
            "steps": steps, "gnorm": gnorm, "seconds": time.perf_counter() - t0,
            "objective": best,
            "fit_objective_rel": (objective(w, float(params["bias"].cpu()[0])) - best) / best,
            "w_norm": float(np.linalg.norm(w64)),
            "cosine": float(w @ w64 / (np.linalg.norm(w) * np.linalg.norm(w64)))}
        return params, metrics

    closed_loop.train_detector = recorded_train_detector
    t0 = time.perf_counter()
    res = closed_loop.run_closed_loop(
        cfg, seed=args.seed, n_train=N_TRAIN, n_eval=N_EVAL, epochs=EPOCHS,
        batch_size=BATCH_SIZE, noise_rms=NOISE_RMS, anyband=True, log_fn=log_fn)
    wall = time.perf_counter() - t0
    phases.pop("first_epoch_record", None)

    records = [r for r in log if "epoch" in r]
    # an epoch's `sec` is the host's time between its boundaries; the epoch
    # loop finalises records one epoch late and drains only after the last,
    # so the middle epochs' mean is the steady rate (the first holds the
    # first step's set-up, the last the drain)
    middle = [r["sec"] for r in records[1:-1]] or [r["sec"] for r in records]
    steady = sum(middle) / len(middle)
    clips = (N_TRAIN // BATCH_SIZE) * BATCH_SIZE
    drop = ("masks", "magnitude", "relevant_wavs", "irrelevant_wavs", "probs", "per_clip")
    summary = {
        "device": {"name_power_limit": smi, "kind": torch.cuda.get_device_name(0)},
        "args": {**vars(args), "n_train": N_TRAIN, "n_eval": N_EVAL, "epochs": EPOCHS,
                 "batch_size": BATCH_SIZE, "noise_rms": NOISE_RMS,
                 "embedder": dataclasses.asdict(cfg.embedder)},
        "detector": res["detector"],
        "detector_fit": {**fit, "seconds": phases["train_detector"],
                         "lbfgs": next(r["lbfgs"] for r in log if "lbfgs" in r)},
        "detector_holdout": res["detector_holdout"],
        **{phase: {k: ({kk: vv for kk, vv in v.items() if kk not in drop}
                       if isinstance(v, dict) else v)
                   for k, v in res[phase].items()}
           for phase in ("before", "after", "after_train")},
        "epoch_sec_first": records[0]["sec"], "epoch_sec_last": records[-1]["sec"],
        "epoch_sec_steady": steady, "clips_per_s_steady": clips / steady,
        "final_record": records[-1], "wall_s": wall, "phase_s": phases,
    }
    if args.out:
        path = Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({**summary, "train_log": records}, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
