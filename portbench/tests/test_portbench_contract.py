"""`BENCHMARK.json` and the files it names: the contract's shapes and
characters, every cell, configuration, traffic mix, driver and metric found
by name, and the imports of every module under `portbench/`."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from portbench import check, harness

HERE = harness.HERE
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH_WORDS = ("hidden_size", "intermediate", "latent", "state", "proj", "head_dim", "expansion",
               "per_tok", "conv_dim")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group in ("end_to_end", "per_layer"), entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
                    assert "\t" not in entry[key]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    metric_names = [n for is_metric, n in names if is_metric]
    assert len(metric_names) == len(set(metric_names))


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        data = json.loads((harness.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank", "_size")), key
            assert not any(word in key for word in WIDTH_WORDS), key
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_configuration_files_state_what_runs():
    """The model's published keys and the pipeline's embedder agree."""
    for c in BENCH["configs"]:
        data = json.loads((harness.ROOT / c["file"]).read_text())
        m, e = data["model"], data["pipeline"]["embedder"]
        pairs = {"hidden_size": "hidden_size", "num_attention_heads": "num_heads",
                 "intermediate_size": "intermediate_size", "conv_dim": "conv_dim",
                 "conv_kernel": "conv_kernel", "conv_stride": "conv_stride",
                 "num_conv_pos_embeddings": "num_conv_pos_embeddings",
                 "num_conv_pos_embedding_groups": "num_conv_pos_embedding_groups",
                 "layer_norm_eps": "layer_norm_eps", "num_hidden_layers": "num_layers"}
        for src, dst in pairs.items():
            assert m[src] == e[dst], src
        tanh = m["hidden_act"] != "gelu"
        assert (e["gelu"] == "tanh") == tanh and (m["feat_extract_activation"] != "gelu") == tanh
        numbers = {"offline_batches": check.EXPLAIN_NUMBERS, "open_loop_http": check.SERVE_NUMBERS,
                   "train_steps": check.TRAIN_NUMBERS}
        for kind, limits in data["limits"].items():
            assert set(limits) == set(numbers[kind]), kind


def test_workloads():
    assert 1 <= len(BENCH["workloads"]) <= 24
    pairs = set()
    configs = {c["name"] for c in BENCH["configs"]}
    four = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    e2e = BENCH["end_to_end"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    names = {m["name"] for m in e2e}
    assert "setup_s" in names
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in names and m["moves"] != "setup_s"
        moved = next(x for x in e2e if x["name"] == m["moves"])
        for w in m.get("workloads", []):
            assert w in moved.get("workloads", [w]), (m["name"], w)
    for w in BENCH["workloads"]:
        mine, layer = harness.metrics_of(w["name"], BENCH)
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert layer, w["name"]
    assert any("mfu" in m["name"] for m in BENCH["per_layer"])


def test_found_by_name():
    for w in BENCH["workloads"]:
        cell, cfg, traffic = harness.cell_files(w["name"], BENCH)
        assert (HERE / "drivers" / f"{traffic['kind']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_imports(path):
    """By whole top-level names: the port's name begins with the JAX
    package's, and is allowed; `reference/` imports nothing of the port."""
    found = _imports(path)
    assert not found & {"jax", "jaxlib", "flax", "xai_audio_deepfakes_tpu", "benchmarks", "bench"}
    if "reference" in path.parts:
        assert "xai_audio_deepfakes_tpu_torch" not in found


def test_forbidden_modules_compares_whole_names():
    mods = ["xai_audio_deepfakes_tpu_torch", "xai_audio_deepfakes_tpu_torch.ops", "jaxlib",
            "jax.numpy", "xai_audio_deepfakes_tpu.ops", "flaxen", "jaxtyping"]
    assert harness.forbidden_modules(mods) == ["jax.numpy", "jaxlib", "xai_audio_deepfakes_tpu.ops"]
