"""PyTorch port: the span recorder (`utils/profiling.py`) at tiny geometry on
the CPU: the no-op when off, the stages of an explain and of a training
step (each called once, children inside parents, the int8 passes only with
int8), outputs bit for bit with and without spans, the epoch clock against
the profiler's, threads, the serving path's records, and the benchmark's
`SpanTrace` leaving a trace's busy time and operations as they were."""

import dataclasses
import http.client
import io
import threading
import time
import wave

import numpy as np
import pytest
import torch

from portbench import spans as pb_spans
from portbench import tracing as pb_tracing
from xai_audio_deepfakes_tpu_torch import config as tc
from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline
from xai_audio_deepfakes_tpu_torch.serve import api
from xai_audio_deepfakes_tpu_torch.train.train_addvisor import init_train_state, make_train_step
from xai_audio_deepfakes_tpu_torch.utils import profiling

EXPLAIN = ("explain.stft", "explain.decoder", "explain.istft", "explain.embed", "explain.head")
EMBED = ("embed.frontend", "embed.projection", "embed.pos_conv", "embed.layers")
TRAIN = ("train.collate", "train.forward", "train.backward", "train.optimiser")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny CPU work (backward passes too) beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def recorder():
    profiling.off()
    profiling.reset()
    yield profiling
    profiling.off()
    profiling.reset()


def tiny(quant: str = "none") -> tc.PipelineConfig:
    return tc.PipelineConfig(
        audio=tc.AudioConfig(clip_seconds=0.5),
        embedder=dataclasses.replace(tc.EmbedderConfig.tiny(), quant=quant),
        unet=tc.UNetConfig(freq_bins=64, frames=24, base_channels=4))


@pytest.fixture(scope="module")
def pipe():
    return ADDvisorPipeline(tiny(), device="cpu", seed=3)


@pytest.fixture(scope="module")
def wav():
    return torch.from_numpy(np.random.default_rng(5).uniform(-0.3, 0.3, (2, 8000))
                            .astype(np.float32))


def _inside(child, parent) -> bool:
    return parent[2] <= child[2] and child[3] <= parent[3]


def test_off_is_one_shared_no_op(pipe, wav):
    assert profiling.span("a.b") is profiling.span("c.d")
    with profiling.span("a.b") as got:
        assert got is None
    profiling.interval("a.queue", time.time_ns())
    profiling.count("a.depth", 3)
    pipe.explain(wav)
    assert profiling.read() == {} and profiling.records() == [] and profiling.counters() == {}


def test_paused_opens_no_record_function_in_a_profile(pipe, wav):
    """A profiler turns the recorder on; `paused()` keeps its spans out."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with profiling.paused(), torch.profiler.profile(activities=acts) as prof:
        assert profiling.span("a.b") is profiling.span("c.d")
        pipe.explain(wav)
    assert not {ev.name for ev in prof.events()} & set(EXPLAIN + EMBED)
    assert profiling.read() == {}
    with torch.profiler.profile(activities=acts) as prof:
        pipe.explain(wav)
    assert set(EXPLAIN) <= {ev.name for ev in prof.events()} and set(EXPLAIN) <= set(
        profiling.read())


@pytest.mark.parametrize("quant", ("none", "int8"))
def test_explain_stages(quant, pipe, wav):
    p = pipe if quant == "none" else ADDvisorPipeline(tiny(quant), device="cpu", seed=3)
    p.explain(wav)
    profiling.on()
    p.explain(wav)
    got = profiling.read()
    for name in EXPLAIN + EMBED:
        assert got[name]["calls"] == 1 and got[name]["host_ms"] > 0, name
        assert got[name]["device_ms"] is None
    int8 = {n for n in got if n.startswith("int8.")}
    assert int8 == ({"int8.quantize", "int8.rescale"} if quant == "int8" else set())
    assert all(got[n]["calls"] > 0 for n in int8)
    recs = {r[0]: r for r in profiling.records() if r[0] in EXPLAIN + EMBED}
    ends = [recs[n] for n in EXPLAIN]
    assert all(a[3] <= b[2] for a, b in zip(ends, ends[1:]))
    assert all(_inside(recs[n], recs["explain.embed"]) for n in EMBED)
    for r in profiling.records("int8."):
        assert _inside(r, recs["embed.layers"]) or _inside(r, recs["embed.pos_conv"])


def test_features_path_embeds_twice():
    """The feature decoder reads the clean clip's embed: 80000-sample clips
    through the default convs (249 frames, as the STFT's) at narrow widths."""
    cfg = tc.PipelineConfig(
        embedder=tc.EmbedderConfig(hidden_size=32, num_layers=2, num_heads=2,
                                   intermediate_size=64, conv_dim=(8,) * 7,
                                   num_conv_pos_embeddings=16,
                                   num_conv_pos_embedding_groups=2, output_layer=2),
        unet=tc.UNetConfig(freq_bins=64, frames=24, base_channels=4),
        feat_decoder=tc.FeatDecoderConfig(feature_dim=32, hidden=16))
    p = ADDvisorPipeline(cfg, device="cpu", seed=3)
    profiling.on()
    p.explain(torch.zeros(1, 80000), decoder="features")
    got = profiling.read()
    assert got["explain.embed"]["calls"] == 2 and got["embed.layers"]["calls"] == 2
    assert all(got[n]["calls"] == 1 for n in EXPLAIN if n != "explain.embed")


def test_explain_bit_identical_with_spans(pipe, wav):
    off = pipe.explain(wav)
    profiling.on()
    on = pipe.explain(wav)
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def _steps(n: int, mark=None) -> list:
    torch.manual_seed(0)
    p = ADDvisorPipeline(tiny(), device="cpu", seed=4)
    state = init_train_state(p)
    step = make_train_step(p, mark=mark)
    clips = np.random.default_rng(6).uniform(-0.3, 0.3, (n, 2, 8000)).astype(np.float32)
    out = []
    for i in range(n):
        _, aux = step(state, torch.from_numpy(clips[i]))
        out.append(aux["loss_vec"].clone())
    return out + [t.detach().clone() for t in state.decoder.parameters()] + [state.w_raw.clone()]


def test_training_steps_bit_identical_and_marked():
    off = _steps(3)
    marks: list = []
    profiling.on()
    on = _steps(3, mark=marks.append)
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    assert marks == ["collate", "forward", "backward", "optimiser"] * 3
    got = profiling.read()
    assert all(got[n]["calls"] == 3 for n in TRAIN)
    recs = [r for r in profiling.records("train.")]
    assert [r[0] for r in recs] == list(TRAIN) * 3
    assert all(a[3] <= b[2] for a, b in zip(recs, recs[1:]))


def test_epoch_clock_holds_the_profilers_event():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("t.clock"):
            torch.randn(64, 64) @ torch.randn(64, 64)
            time.sleep(0.005)
    t0 = pb_spans.trace_start_ns(prof)
    (ev,) = [ev for ev in prof.events() if ev.name == "t.clock"]
    (rec,) = profiling.records("t.")
    slack = 1_000_000
    assert rec[2] - slack <= t0 + 1000 * ev.time_range.start
    assert t0 + 1000 * ev.time_range.end <= rec[3] + slack
    assert rec[3] - rec[2] < 1000 * (ev.time_range.end - ev.time_range.start) + slack


def test_thread_id_and_bounded_ring():
    profiling.on()
    ids: list = []

    def work():
        ids.append(threading.get_ident())
        with profiling.span("t.worker"):
            pass

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    (rec,) = profiling.records("t.worker")
    assert rec[1] == ids[0] != threading.get_ident()
    for _ in range(profiling.RING + 10):
        with profiling.span("t.many"):
            pass
    assert len(profiling.records()) == profiling.RING
    assert profiling.read()["t.many"]["calls"] == profiling.RING + 10


def _wav_bytes(x: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def test_served_requests_are_stamped_in_order(pipe):
    server, service = api.start_api_server(pipe, port=0, batch_size=2, linger_ms=50.0)
    clips = np.random.default_rng(7).uniform(-0.3, 0.3, (3, 8000))
    status: list = []

    def post(x):
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
        conn.request("POST", "/explain?audio=0", body=_wav_bytes(x))
        resp = conn.getresponse()
        resp.read()
        status.append(resp.status)
        conn.close()

    profiling.on()
    try:
        threads = [threading.Thread(target=post, args=(x,)) for x in clips]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and status == [200] * 3
    finally:
        profiling.off()
        server.shutdown()
        server.server_close()
        service.stop()
    records = profiling.records("serve.")
    reqs = pb_spans.requests(records)
    assert len(reqs) == 3
    for q in reqs:
        assert (q["start"] <= q["put"] <= q["get"] <= q["closed"] <= q["explain_start"]
                <= q["explain_end"] <= q["reply"])
    names = {r[0] for r in records}
    assert names == {"serve.request", "serve.decode", "serve.queue", "serve.linger",
                     "serve.explain", "serve.host_copy", "serve.rows", "serve.encode"}
    depth = profiling.counters()["serve.queue_depth"]
    assert depth["calls"] == len([r for r in records if r[0] == "serve.explain"])
    assert 0 <= depth["max"] <= 2


def test_span_trace_keeps_the_trace(pipe, wav):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pipe.explain(wav)
    plain = pb_tracing.Trace(prof, 0.5, 1)
    named = pb_spans.SpanTrace(prof, 0.5, 1, profiling.records())
    assert (named.busy_s, named.wall_s, named.ops) == (plain.busy_s, plain.wall_s, plain.ops)
    assert named.spans and {s[2] for s in named.spans} >= set(EXPLAIN)
    mid = (named.spans[0][0] + named.spans[0][1]) / 2
    assert named._host_at(mid) != "host: no operation"
    assert named._host_at(-1e9) == plain._host_at(-1e9) == "host: no operation"
