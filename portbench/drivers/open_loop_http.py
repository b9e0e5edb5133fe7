"""The live explain API under open-loop load: `serve/api.py::
start_api_server(pipe, batch_size, linger_ms, decoder="unet")` in this
process, `loadgen.py` in another, POSTing seeded 16-bit WAV clips at a fixed
Poisson rate (the traffic file's `rate_per_s`).

Set-up: the pipeline and its weights (as the offline cells), the clip pool
(made on the device, written as int16 PCM into the run's directory), the
server (its start explains one zero batch) and the load generator, up to its
READY. The window: the generator's arrivals over `seconds`, and the replies
still due (up to `drain_s` more). `serve_p95_ms` is the 95th percentile of
every request's time from its due time to its full reply; a failed or
missing reply counts at the drain's end. With `--trace 1` the profiler runs
for `trace_seconds` from the window's middle.

After the window the pipeline is freed and the plain reference explains
the sampled requests' clips, as the server decoded them (int16 / 32768); its
waveforms are written to 16 bits as the server writes them before the
comparison.
"""

from __future__ import annotations

import base64
import gc
import io
import json
import subprocess
import sys
import time
import wave
from pathlib import Path

import numpy as np
import torch

from portbench import check, tracing, weights
from portbench.cellkit import make_pool, pipeline_config, prepared_weights
from portbench.reference import explain as ref_explain

HERE = Path(__file__).resolve().parents[1]


def pcm16(x: np.ndarray) -> np.ndarray:
    """A waveform as 16-bit PCM codes: clip to [-1, 1], times 32767, the
    fraction dropped."""
    return (np.clip(x, -1.0, 1.0) * 32767).astype(np.int16)


def read_wav16(data: bytes) -> np.ndarray:
    with wave.open(io.BytesIO(data)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float32) / 32768.0


def reply_of(out: dict, i: int, sample_rate: int) -> dict:
    """Row i of an explain's outputs (numpy, with the magnitude) as the
    service replies it: the three probabilities, the mask's mean and kept
    energy, both waveforms as base64 16-bit WAV."""
    mask, mag = out["mask"][i], out["magnitude"][i]
    reply = {"pred_original": float(out["probs_clean"][i, 0]),
             "pred_relevant": float(out["probs_relevant"][i, 0]),
             "pred_irrelevant": float(out["probs_irrelevant"][i, 0]),
             "mask_mean": float(mask.mean()),
             "mask_energy_kept": float(((mask * mag) ** 2).sum()
                                       / max(float((mag ** 2).sum()), 1e-12))}
    for key in ("relevant_wav", "irrelevant_wav"):
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sample_rate)
            w.writeframes(pcm16(out[key][i]).astype("<i2").tobytes())
        reply[key + "_b64"] = base64.b64encode(buf.getvalue()).decode()
    return reply


def reply_numbers(reply: dict, want: dict) -> dict:
    """A served reply against the reply the reference's explain makes
    (`reply_of`)."""
    stats = max(abs(reply[k] - want[k]) for k in ("mask_mean", "mask_energy_kept"))
    probs = max(abs(reply[k] - want[k]) for k in ("pred_original", "pred_relevant",
                                                  "pred_irrelevant"))
    rel = []
    for key in ("relevant_wav_b64", "irrelevant_wav_b64"):
        got = read_wav16(base64.b64decode(reply[key])).astype(np.float64)
        ref = read_wav16(base64.b64decode(want[key])).astype(np.float64)
        rel.append(float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))
                   if got.shape == ref.shape else float("inf"))
    return {"mask_stats_max_abs": stats, "prob_max_abs": probs, "wav_rel_l2": max(rel)}


def _percentile(values: list, q: float) -> float:
    v = sorted(values)
    return v[min(len(v) - 1, max(0, int(np.ceil(q * len(v))) - 1))]


def run(run) -> dict:
    from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline
    from xai_audio_deepfakes_tpu_torch.serve.api import start_api_server

    cfg, traffic, dev = run.cfg["pipeline"], run.traffic, run.device
    marks = [("start", run.since_start())]
    pipe = ADDvisorPipeline(pipeline_config(cfg), device=dev, seed=0)
    w = prepared_weights(run.cfg, traffic, run.seed, dev)
    weights.load_into(pipe, w)
    w = weights.to(w, "cpu")
    pool_t = make_pool(cfg, dict(traffic, batch=traffic["pool_clips"], pool_batches=1),
                       run.seed, dev)[0]
    pool = pcm16(pool_t.cpu().numpy())
    del pool_t
    out_dir = run.out_dir()
    np.save(out_dir / f"pool_seed{run.seed}.npy", pool)
    marks.append(("weights, pool", run.since_start()))
    run.reset_peak()
    explain = run.hook(lambda wav: pipe.explain(wav, decoder="unet"))
    server, service = start_api_server(pipe, port=0, batch_size=traffic["batch_size"],
                                       linger_ms=traffic["linger_ms"], decoder="unet",
                                       explain_fn=explain)
    marks.append(("server", run.since_start()))
    result_file = out_dir / f"load_seed{run.seed}.json"
    gen = subprocess.Popen(
        [sys.executable, str(HERE / "loadgen.py"), "--port", str(server.server_address[1]),
         "--pool", str(out_dir / f"pool_seed{run.seed}.npy"), "--rate", str(traffic["rate_per_s"]),
         "--seconds", str(run.seconds), "--seed", str(run.seed),
         "--clients", str(traffic["clients"]), "--sample", str(traffic["sample_replies"]),
         "--drain", str(traffic["drain_s"]), "--out", str(result_file),
         "--sample-rate", str(cfg["audio"]["sample_rate"])],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        if gen.stdout.readline().strip() != "READY":
            raise RuntimeError("the load generator did not start")
        run.sync()
        setup_s = run.since_start()
        marks.append(("generator", setup_s))
        before = dict(service.stats)
        smi_before = run.smi()
        gen.stdin.write("go\n")
        gen.stdin.flush()
        t0 = time.perf_counter()
        trace = None
        if run.trace:
            time.sleep(max(0.0, run.seconds / 2 - traffic["trace_seconds"] / 2))
            got: dict = {}
            with tracing.profiled(got, run.cuda):
                time.sleep(traffic["trace_seconds"])
            trace = tracing.Trace(got["prof"], got["wall_s"], 1)
            run.save_trace(got["prof"])
        done = gen.stdout.readline().strip()
        gen.wait(timeout=traffic["drain_s"] + 60)
        if done != "DONE" or gen.returncode != 0:
            raise RuntimeError(f"the load generator failed ({gen.returncode})")
        window_s = time.perf_counter() - t0
        after = dict(service.stats)
        smi_after = run.smi()
    finally:
        if gen.poll() is None:
            gen.kill()
            gen.wait()
        server.shutdown()
        server.server_close()
        service.stop()
    peak = run.peak()
    load = json.loads(result_file.read_text())
    records = load["records"]
    end = load["window_s"] + traffic["drain_s"]
    lat, failed = [], 0
    for r in records:
        ok = r is not None and r["status"] == 200
        failed += not ok
        lat.append((r["done"] - r["due"]) if ok else end - (r["due"] if r else 0.0))
    batches = after["batches"] - before["batches"]
    rows = after["batched_rows"] - before["batched_rows"]

    del pipe, server, service, explain
    gc.collect()
    run.empty_cache()
    sampled = [(k, r) for k, r in enumerate(records) if r is not None and r["reply"] is not None]
    n_sample = min(traffic["sample_replies"], len(records))
    numbers = {k: float("inf") for k in ("mask_stats_max_abs", "prob_max_abs", "wav_rel_l2")}
    if sampled and len(sampled) == n_sample:
        w = weights.to(w, dev)
        wav = torch.from_numpy(np.stack([pool[r["clip"]] for _, r in sampled]).astype(np.float32)
                               / 32768.0).to(dev)
        with torch.no_grad(), ref_explain.precise():
            ref = ref_explain.explain(w, wav, cfg, with_magnitude=True)
        ref = {k: v.float().cpu().numpy() for k, v in ref.items()}
        numbers = {}
        sr = cfg["audio"]["sample_rate"]
        for i, (_, r) in enumerate(sampled):
            numbers = check.merge(numbers, reply_numbers(r["reply"], reply_of(ref, i, sr)))
    marks_line = ", ".join(f"{k} {v:.3f}" for k, v in marks)
    return {
        "attempted": len(records),
        "failed": failed,
        "end_to_end": {"serve_p95_ms": 1e3 * _percentile(lat, 0.95), "setup_s": setup_s},
        "window": {"units": len(records), "seconds": load["window_s"], "batches": batches,
                   "rows": rows, "latency_p50_ms": 1e3 * _percentile(lat, 0.5),
                   "outstanding_at_end": load["outstanding_at_end"]},
        "trace": trace,
        "memory_peak_bytes": peak,
        "numbers": numbers,
        "log": [f"set-up marks (s since start): {marks_line}",
                f"generator lateness: p95 {load['late_p95_s']:.6f} s, "
                f"max {load['late_max_s']:.6f} s",
                f"requests {len(records)}, failed {failed}, batches {batches}, rows {rows}, "
                f"p50 {1e3 * _percentile(lat, 0.5):.1f} ms, "
                f"p95 {1e3 * _percentile(lat, 0.95):.1f} ms, "
                f"outstanding when arrivals ended {load['outstanding_at_end']}, "
                f"wall {window_s:.2f} s",
                f"card (sm clock, power, temperature) before the window: {smi_before}; "
                f"after: {smi_after}"],
    }
