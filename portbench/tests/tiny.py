"""A tiny cell of each configuration, for the CPU tests: the files' own
settings with the widths, depth, clip length and UNet cut down."""

from __future__ import annotations

import copy

from portbench import harness

TINY_EMBEDDER = dict(hidden_size=32, num_layers=2, output_layer=2, num_heads=2,
                     intermediate_size=64, conv_dim=[8, 8, 8], conv_kernel=[10, 3, 2],
                     conv_stride=[5, 2, 2], num_conv_pos_embeddings=16,
                     num_conv_pos_embedding_groups=2)
TINY_UNET = dict(freq_bins=64, frames=24, base_channels=4)


# the live API under open-loop load: its driver runs, but its tail's spread
# admits no bound yet, so BENCHMARK.json does not list it (PERF.md, section 7)
SERVED = {"name": "entry-serve", "config": "xlsr2b-l9-entry", "traffic": "serve_poisson",
          "chips": 1}


def tiny_files(workload, batch: int = 2, pool: int = 2) -> tuple:
    """(cell, configuration, traffic) of `workload` (a cell of BENCHMARK.json
    by name, or a cell's entry) cut to a CPU's size."""
    if isinstance(workload, str):
        cell, cfg, traffic = harness.cell_files(workload)
    else:
        cell = workload
        cfg = harness.load_json(harness.HERE / "configs" / f"{cell['config']}.json")
        traffic = harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json")
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    p = cfg["pipeline"]
    p["audio"]["clip_seconds"] = 0.5
    p["embedder"].update(TINY_EMBEDDER)
    p["unet"].update(TINY_UNET)
    cfg["weights"]["calibration_clips"] = 4
    traffic.update(batch=batch, pool_batches=max(pool, traffic.get("checked_steps", 0) + 1),
                   trace_batches=1, warm_batches=1, trace_steps=1)
    return dict(cell, chips=1), cfg, traffic


def argv(workload, seed: int = 2**31 + 11, seconds: float = 0.2, trace: int = 0) -> list:
    name = workload if isinstance(workload, str) else workload["name"]
    return ["--workload", name, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)]
