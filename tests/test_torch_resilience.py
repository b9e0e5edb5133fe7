"""PyTorch port, `utils/resilience.py`: `run_attempts` on tiny `python -c`
children (a failing attempt then a succeeding one, total failure, a
timeout, the phases collected from stderr), its result-line parser
against the JAX package's, and `device_preflight` on the CPU and without
CUDA."""

import sys
from pathlib import Path

import pytest
import torch

from xai_audio_deepfakes_tpu.utils import resilience as jres
from xai_audio_deepfakes_tpu_torch.utils import resilience as tres

ROOT = Path(__file__).resolve().parents[1]
# the child reads its attempt's environment: MODE=fail exits 3 after two
# phases, MODE=ok prints a result line after noise, MODE=hang sleeps
CHILD = [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r})" + """
import json, os, time
from xai_audio_deepfakes_tpu_torch.utils.resilience import phase
phase("imports")
mode = os.environ.get("MODE")
if mode == "hang":
    time.sleep(30)
phase("measure")
if mode == "fail":
    print("Traceback: device lost", file=sys.stderr)
    sys.exit(3)
print("warming up")
print(json.dumps({"value": 7, "batch": os.environ.get("BATCH")}))
phase("done")
"""]


def test_failing_then_succeeding_attempt():
    result, records = tres.run_attempts(
        CHILD, [("first", {"MODE": "fail"}), ("second", {"MODE": "ok", "BATCH": 4})])
    assert result == {"value": 7, "batch": "4"}
    assert [r["label"] for r in records] == ["first", "second"]
    assert [(r["rc"], r["ok"]) for r in records] == [(3, False), (0, True)]
    assert records[0]["stderr_tail"] == ["Traceback: device lost"]
    assert records[1]["env"] == {"MODE": "ok", "BATCH": 4} and "stderr_tail" not in records[1]
    assert all(r["seconds"] > 0 for r in records)


def test_total_failure_returns_records():
    result, records = tres.run_attempts(
        CHILD, [("a", {"MODE": "fail"}), ("b", {"MODE": "fail"})], stderr_tail_lines=1)
    assert result is None
    assert [(r["label"], r["rc"], r["ok"]) for r in records] == [("a", 3, False), ("b", 3, False)]
    assert all(r["stderr_tail"] == ["Traceback: device lost"] for r in records)


def test_timeout_gives_rc_minus_one():
    result, records = tres.run_attempts(CHILD, [("slow", {"MODE": "hang"})], timeout_s=5.0)
    assert result is None
    (rec,) = records
    assert rec["rc"] == -1 and not rec["ok"] and rec["phases"] == ["imports"]
    assert rec["stderr_tail"][-1] == "[run_attempts] timeout after 5.0s"


def test_phases_collected_from_stderr():
    _, records = tres.run_attempts(CHILD, [("fail", {"MODE": "fail"}), ("ok", {"MODE": "ok"})])
    assert [r["phases"] for r in records] == [["imports", "measure"],
                                              ["imports", "measure", "done"]]


@pytest.mark.parametrize("stdout", [
    '{"a": 1}\nnoise\n{"b": 2}\n  \n',
    'x\n{"a": 1}\n{not json\n[1, 2]\n',
    "no result\n",
    "",
])
def test_result_line_parser_equals_jax(stdout):
    assert tres._parse_result_line(stdout) == jres._parse_result_line(stdout)


def test_device_preflight_on_cpu():
    out = tres.device_preflight(device="cpu")
    assert out == {"device": "cpu", "value": 128.0 * 128 * 128}


def test_device_preflight_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tres.device_preflight(retries=0)
