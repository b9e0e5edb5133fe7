"""The control of each cell on the card: the plain reference put in the
program's place one precision step lower (bf16 for an f32 UNet, float8
operands for bf16 products, int4 for int8 products) is not correct by the
cell's limits, while the program is (offline and training cells; a served
cell's program is held by its runs); at the cell's sizes with one pool
batch (a served cell: `sample_replies` clips), three seeds. Skips without a
card; on the card:

    pytest -m gpu portbench/tests/test_portbench_control.py
"""

from __future__ import annotations

import pytest
import torch

from portbench import check, harness, limits

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_and_program_passes(cuda, workload):
    _, cfg_file, traffic = harness.cell_files(workload)
    kind = traffic["kind"]
    bounds = cfg_file["limits"][kind]
    if kind == "offline_batches":
        traffic = dict(traffic, pool_batches=1)
    pipe = limits.make_pipeline(cfg_file["pipeline"]) if kind != "open_loop_http" else None
    for seed in SEEDS:
        if kind == "offline_batches":
            assert check.verdict(limits.program_offline(seed, pipe, cfg_file, traffic), bounds)[0]
        elif kind == "train_steps":
            assert check.verdict(limits.program_train(seed, pipe, cfg_file, traffic), bounds)[0]
        assert not check.verdict(limits.control(seed, cfg_file, traffic), bounds)[0], seed
    del pipe
    torch.cuda.empty_cache()
