"""The span readers (`layer_metrics/*` over `spans.py`) on a fake reading:
device ms over the traced units, the int8 passes summed, nothing where a
span is missing, has no device time or the program has no recorder, and
the serving readers' percentiles over joined request stamps."""

from __future__ import annotations

import types

import pytest

from portbench import harness, spans
from portbench.harness import Reading

SPAN_OF = {"explain.embed_ms": ("explain.embed",), "explain.decoder_ms": ("explain.decoder",),
           "embed.frontend_ms": ("embed.frontend",), "embed.pos_conv_ms": ("embed.pos_conv",),
           "int8.passes_ms": ("int8.quantize", "int8.rescale"),
           "train.backward_ms": ("train.backward",)}


def reading(window: dict, units: int = 4) -> Reading:
    return Reading(types.SimpleNamespace(units=units), window, {}, {}, {})


@pytest.mark.parametrize("metric", sorted(SPAN_OF))
def test_device_ms_over_units(metric):
    read = harness.load_reader(metric)
    names = SPAN_OF[metric]
    window = {"spans": {n: {"calls": 40, "host_ms": 9.0, "device_ms": 10.0 * (i + 1)}
                        for i, n in enumerate(names)}}
    assert read(reading(window)) == pytest.approx(sum(10.0 * (i + 1) for i in range(len(names)))
                                                  / 4)
    window["spans"][names[-1]]["device_ms"] = None  # the CPU's spans
    assert read(reading(window)) is None
    del window["spans"][names[-1]]
    assert read(reading(window)) is None
    assert read(Reading(None, {"spans": {}}, {}, {}, {})) is None


def test_no_recorder_reads_nothing(monkeypatch):
    """A program without the recorder (the commit before it): every reader
    leaves its metric out."""
    monkeypatch.setattr(spans, "_profiling", lambda: None)
    for metric in list(SPAN_OF) + ["serve.queue_wait_ms", "serve.in_program_p95_ms"]:
        assert harness.load_reader(metric)(reading({})) is None


def _served(n: int) -> list:
    """n requests on threads 1..n, two to a batch: request i starts at 100 i
    ms and is put 1 ms later; a batch lingers from its first get to 4 ms
    after its second, then runs 50 ms; replies are written 2 ms after."""
    ms = 1_000_000
    out = []
    for b in range(0, n, 2):
        first = 100 * b * ms + ms
        close = 100 * (b + 1) * ms + 6 * ms
        out += [("serve.linger", 0, first + ms, close),
                ("serve.explain", 0, close, close + 50 * ms)]
        for i in (b, b + 1):
            put = 100 * i * ms + ms
            get = max(put, first) + ms
            out += [("serve.request", i + 1, 100 * i * ms, close + 52 * ms),
                    ("serve.queue", i + 1, put, get)]
    return out


def test_serving_readers():
    records = _served(20)
    got = spans.requests(records)
    assert len(got) == 20
    waits = [(q["closed"] - q["put"]) / 1e6 for q in got]
    assert waits == [105.0, 5.0] * 10
    assert harness.load_reader("serve.queue_wait_ms")(
        reading({"serve_records": records})) == pytest.approx(105.0)
    # a batch's first request takes 158 ms in the program, its second 58
    assert harness.load_reader("serve.in_program_p95_ms")(
        reading({"serve_records": records})) == pytest.approx(158.0)
    assert harness.load_reader("serve.queue_wait_ms")(reading({"serve_records": []})) is None


def test_a_request_missing_a_stamp_is_left_out():
    records = [r for r in _served(4) if not (r[0] == "serve.queue" and r[1] == 2)]
    assert [q["thread"] for q in spans.requests(records)] == [1, 3, 4]
