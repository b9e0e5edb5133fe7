#!/usr/bin/env python3
"""Where the time of one `explain(decoder="unet")` of the PyTorch/CUDA port
goes, on the card. A development profiler, run from the root of a checkout:

    python3 profile_explain.py [--batch 8] [--out FILE] [--cudnn-benchmark] [--fused-conv]
    python3 profile_explain.py --train [--batch 2] [--unet-dtype bfloat16] [--out FILE]

Builds the full-width pipeline of `chip_smoke.py` (bf16 XLS-R-2B truncation,
default UNet, random weights from a seed), then traces 5 explains with
torch.profiler and reports
  * the program's spans (`utils/profiling.py`), which record while the
    profiler runs: calls, host ms and device ms (CUDA events at each span's
    edges) of each `explain.*`, `embed.*` and `int8.*` stage, per explain;
  * device time by kernel name, and the device's busy share of the traced
    wall time (the union of the kernels' intervals over the host's wall
    clock).

With --train it profiles LMAC training steps of the UNet decoder instead
(`chip_smoke.py`'s training configuration: bf16 embedder with both fused
frontend kernels, f32 UNet, or the bf16 UNet with --unet-dtype
bfloat16): the spans of 5 traced steps (`train.collate`, `train.forward`,
`train.backward`, `train.optimiser` and what they hold), per step, and the
same kernel table and busy share.

Prints one JSON object (and writes it to --out when given). Needs a CUDA
card: without one it exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPS = 5  # explains or steps per traced window


def _traced(torch, fn, reps: int) -> dict:
    """`fn()` `reps` times under torch.profiler: the kernel table, the busy
    share and the program's spans, each per call."""
    from xai_audio_deepfakes_tpu_torch.utils import profiling

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    profiling.reset()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = {name: {k: None if v is None else v / reps for k, v in s.items()}
             for name, s in profiling.read().items()}
    return {"span_ms_per_rep": spans, **_summarise(prof, reps, wall_ms)}


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


def profile_training(torch, batch: int | None, unet_dtype: str = "float32") -> dict:
    import dataclasses

    import numpy as np

    from xai_audio_deepfakes_tpu_torch.config import EmbedderConfig, PipelineConfig, UNetConfig
    from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline
    from xai_audio_deepfakes_tpu_torch.train.train_addvisor import init_train_state, make_train_step

    cfg = PipelineConfig(embedder=EmbedderConfig(dtype="bfloat16", fused_ln_gelu=True,
                                                 fused_conv=True),
                         unet=UNetConfig(dtype=unet_dtype))
    if batch is not None:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=batch))
    b = cfg.train.batch_size
    pipe = ADDvisorPipeline(cfg, device="cuda", seed=0)
    state = init_train_state(pipe)
    step = make_train_step(pipe)
    rng = np.random.default_rng(1)
    wavs = [torch.from_numpy((rng.standard_normal((b, cfg.audio.num_samples)) * 0.1)
                             .astype(np.float32)).cuda() for _ in range(REPS + 1)]
    step(state, wavs.pop())  # warm-up
    torch.cuda.reset_peak_memory_stats()
    traced = _traced(torch, lambda: step(state, wavs.pop()), REPS)
    return {"device": torch.cuda.get_device_name(0), "mode": "train", "batch": b,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30, **traced}


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
    ap.add_argument("--unet-dtype", default="float32", choices=["float32", "bfloat16"],
                    help="with --train: the trained UNet's compute dtype")
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
        return _emit(profile_training(torch, args.batch, args.unet_dtype), args.out)
    from xai_audio_deepfakes_tpu_torch.config import EmbedderConfig, PipelineConfig
    from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline

    cfg = PipelineConfig(embedder=EmbedderConfig(dtype="bfloat16", fused_ln_gelu=True,
                                                 fused_conv=args.fused_conv))
    pipe = ADDvisorPipeline(cfg, device="cuda", seed=0)
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    b = 8 if args.batch is None else args.batch
    wav = torch.from_numpy(
        np.random.default_rng(0).standard_normal((b, cfg.audio.num_samples)).astype(np.float32)
        * 0.1).cuda()

    pipe.explain(wav)  # warm-up
    result = {
        "device": torch.cuda.get_device_name(0),
        "batch": b,
        "cudnn_benchmark": args.cudnn_benchmark,
        "fused_conv": args.fused_conv,
        **_traced(torch, lambda: pipe.explain(wav), REPS),
    }
    return _emit(result, args.out)


if __name__ == "__main__":
    sys.exit(main())
