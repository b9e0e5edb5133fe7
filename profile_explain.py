#!/usr/bin/env python3
"""Where the time of one `explain(decoder="unet")` of the PyTorch/CUDA port
goes, on the card. A development profiler, run from the root of a checkout:

    python3 profile_explain.py [--batch 8] [--out FILE] [--cudnn-benchmark] [--fused-conv]
    python3 profile_explain.py --train [--batch 2] [--out FILE]

Builds the full-width pipeline of `chip_smoke.py` (bf16 XLS-R-2B truncation,
default UNet, random weights from a seed), then

  * times each public stage on its own with CUDA events (mean of 5 calls
    after a warm-up): spectrogram, predict_mask, the two iSTFTs with
    their masking, and the 3B-batch embedder split into frontend,
    projection + positional conv, transformer layers;
  * traces 5 explains with torch.profiler and sums device time by
    kernel name, and the device's busy share of the traced wall time (the
    union of the kernels' intervals over the host's wall clock).

With --train it profiles LMAC training steps of the UNet decoder instead
(`chip_smoke.py`'s training configuration: bf16 embedder with both fused
frontend kernels, f32 UNet): the device time of each phase of a step
(collate, forward, backward, optimiser; mean of 5 steps) and the same
kernel table and busy share over 5 traced steps.

Prints one JSON object (and writes it to --out when given). Needs a CUDA
card: without one it exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPS = 5  # calls per timed stage and explains per traced window


def _event_ms(torch, fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _summarise(prof, reps: int, wall_ms: float) -> dict:
    """Device kernels of a trace, each (name, start, end) once: time by name
    per repetition, and the busy share (the union of the kernels' intervals
    over the host's wall clock)."""
    seen, spans, by_name = set(), [], {}
    for ev in prof.events():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        key = (ev.name, ev.time_range.start, ev.time_range.end)
        if key in seen:
            continue
        seen.add(key)
        spans.append((ev.time_range.start, ev.time_range.end))
        agg = by_name.setdefault(ev.name[:120], [0, 0.0])
        agg[0] += 1
        agg[1] += ev.time_range.end - ev.time_range.start
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    kernels = sorted(
        ({"name": n, "calls_per_rep": c / reps, "ms_per_rep": us / 1e3 / reps}
         for n, (c, us) in by_name.items()),
        key=lambda k: -k["ms_per_rep"],
    )
    device_ms = busy_us / 1e3 / reps
    return {"traced_wall_ms_per_rep": wall_ms / reps, "device_ms_per_rep": device_ms,
            "device_busy_share": device_ms / (wall_ms / reps), "top_kernels": kernels[:25]}


def profile_training(torch, batch: int | None) -> dict:
    import dataclasses

    import numpy as np

    from xai_audio_deepfakes_tpu_torch.config import EmbedderConfig, PipelineConfig
    from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline
    from xai_audio_deepfakes_tpu_torch.train.train_addvisor import init_train_state, make_train_step

    cfg = PipelineConfig(embedder=EmbedderConfig(dtype="bfloat16", fused_ln_gelu=True,
                                                 fused_conv=True))
    if batch is not None:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=batch))
    b = cfg.train.batch_size
    pipe = ADDvisorPipeline(cfg, device="cuda", seed=0)
    state = init_train_state(pipe)
    events: list = []

    def mark(name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    step = make_train_step(pipe, mark=mark)
    rng = np.random.default_rng(1)
    wavs = [torch.from_numpy((rng.standard_normal((b, cfg.audio.num_samples)) * 0.1)
                             .astype(np.float32)).cuda() for _ in range(2 * REPS + 1)]
    step(state, wavs.pop())  # warm-up
    phases: dict = {}
    for _ in range(REPS):
        events.clear()
        mark("start")
        step(state, wavs.pop())
        torch.cuda.synchronize()
        for (_, prev), (name, ev) in zip(events, events[1:]):
            phases[name] = phases.get(name, 0.0) + prev.elapsed_time(ev) / REPS
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            step(state, wavs.pop())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return {"device": torch.cuda.get_device_name(0), "mode": "train", "batch": b,
            "phase_ms": phases, "step_ms": sum(phases.values()),
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            **_summarise(prof, REPS, wall_ms)}


def _emit(result: dict, out: str | None) -> int:
    text = json.dumps(result, indent=1)
    print(text)
    if out:
        with open(out, "w") as fh:
            fh.write(text)
    return 0


def main(argv=None) -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=None,
                    help="clips per explain (default 8) or per training step "
                         "(default TrainConfig.batch_size)")
    ap.add_argument("--train", action="store_true", help="profile training steps instead")
    ap.add_argument("--fused-conv", action="store_true",
                    help="explain with EmbedderConfig(fused_conv=True): kernel E for frontend "
                         "layers 1-6")
    ap.add_argument("--out", default=None)
    # an open question of PERF.md: whether the pipeline should set it
    ap.add_argument("--cudnn-benchmark", action="store_true",
                    help="let cuDNN time its algorithms per shape (torch.backends.cudnn.benchmark)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_explain: CUDA is not available", file=sys.stderr)
        return 1

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if args.train:
        return _emit(profile_training(torch, args.batch), args.out)
    from xai_audio_deepfakes_tpu_torch.config import EmbedderConfig, PipelineConfig
    from xai_audio_deepfakes_tpu_torch.ops.masking import apply_mask, remask_complex
    from xai_audio_deepfakes_tpu_torch.ops.normalize import zero_mean_unit_var_norm
    from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline

    cfg = PipelineConfig(embedder=EmbedderConfig(dtype="bfloat16", fused_ln_gelu=True,
                                                 fused_conv=args.fused_conv))
    pipe = ADDvisorPipeline(cfg, device="cuda", seed=0)
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    b = 8 if args.batch is None else args.batch
    wav = torch.from_numpy(
        np.random.default_rng(0).standard_normal((b, cfg.audio.num_samples)).astype(np.float32)
        * 0.1).cuda()

    with torch.inference_mode():
        out = pipe.explain(wav)
        _, _, mag, phase = pipe.spectrogram(wav)
        wav3 = torch.cat([wav, out.relevant_wav, out.irrelevant_wav])
        norm = zero_mean_unit_var_norm(wav3)
        enc = pipe.encoder
        fe = enc.feature_encoder(norm)
        proj = enc.feature_projection(fe)
        x = proj + enc.pos_conv(proj)

        def layers():
            y = x
            for layer in enc.layers:
                y = layer(y)
            return y

        def masked_istfts():
            rel, irr = apply_mask(out.mask, mag, cfg.masking)
            pipe.istft(*remask_complex(rel, phase))
            pipe.istft(*remask_complex(irr, phase))

        r = REPS
        stages = {
            "explain": _event_ms(torch, lambda: pipe.explain(wav), r),
            "spectrogram (STFT, kernel B)": _event_ms(torch, lambda: pipe.spectrogram(wav), r),
            "predict_mask (UNet, f32)": _event_ms(torch, lambda: pipe.predict_mask(mag), r),
            "masking + 2 iSTFT (kernel C)": _event_ms(torch, masked_istfts, r),
            "embedder: normalise": _event_ms(torch, lambda: zero_mean_unit_var_norm(wav3), r),
            "embedder: conv frontend (kernel D, or D and E with fused_conv)": _event_ms(
                torch, lambda: enc.feature_encoder(norm), r),
            "embedder: projection + pos conv": _event_ms(
                torch, lambda: proj + enc.pos_conv(enc.feature_projection(fe)), r),
            f"embedder: {len(enc.layers)} layers (kernel A)": _event_ms(torch, layers, r),
        }

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(r):
                pipe.explain(wav)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3

    trace = _summarise(prof, r, wall_ms)
    result = {
        "device": torch.cuda.get_device_name(0),
        "batch": b,
        "cudnn_benchmark": args.cudnn_benchmark,
        "fused_conv": args.fused_conv,
        "stage_ms": stages,
        **trace,
    }
    return _emit(result, args.out)


if __name__ == "__main__":
    sys.exit(main())
