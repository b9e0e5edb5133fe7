"""PyTorch port: the live explain API (`serve/api.py`) against the JAX
package's on the CPU at tiny geometry, with the same weights: the service's
results (probabilities 1e-4, mask statistics 1e-5), the coalescing of
concurrent requests and the isolation of the padded rows, an HTTP round
trip whose JSON keys equal the JAX handler's and whose WAV payloads decode
within 2e-4 plus one PCM step of JAX's, and the 400 / 413 / 404 paths. The
JAX explain is compiled once for the module."""

import base64
import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_audio_deepfakes_tpu import config as jc
from xai_audio_deepfakes_tpu.pipeline.core import ADDvisorPipeline as JPipeline
from xai_audio_deepfakes_tpu.serve import api as japi
from tests.test_torch_pipeline import _tiny, jax_params  # noqa: F401 (a fixture)
from xai_audio_deepfakes_tpu_torch import config as tc
from xai_audio_deepfakes_tpu_torch.convert import load_jax_params
from xai_audio_deepfakes_tpu_torch.data.io import decode_wav_bytes, wav_to_bytes
from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline
from xai_audio_deepfakes_tpu_torch.serve import api

BATCH = 4
PCM_STEP = 1.0 / 32768


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny CPU work beside the suite's other workers: one intra-op thread
    (several threads per worker oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jpipe():
    return JPipeline(_tiny(jc))


@pytest.fixture(scope="module")
def jax_explain(jpipe):
    """One compiled JAX explain, shared by every JAX service here."""
    return jpipe.jit_explain()


@pytest.fixture(scope="module")
def pipe(jax_params):
    p = ADDvisorPipeline(_tiny(tc), device="cpu", seed=9)
    load_jax_params(p, jax_params)
    return p


@pytest.fixture(scope="module")
def clips():
    """Seeded clips, already on 16-bit PCM steps (as a WAV upload decodes)."""
    x = np.random.default_rng(4).uniform(-0.3, 0.3, (6, 8000))
    return (np.round(x * 32767) / 32768).astype(np.float32)


def _submit_all(service, clips) -> list:
    """Each clip from its own thread at once; results in clip order."""
    out: list = [None] * len(clips)

    def one(i):
        out[i] = service.submit(clips[i])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(clips))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.fixture(scope="module")
def service_results(pipe, jpipe, jax_params, jax_explain, clips):
    """Both services over the same clips, submitted concurrently."""
    params = jax.tree.map(jnp.asarray, jax_params)
    res = {}
    for name, svc in (("port", api.ExplainService(pipe, batch_size=BATCH, linger_ms=50)),
                      ("jax", japi.ExplainService(jpipe, params, batch_size=BATCH, linger_ms=50,
                                                  explain_fn=jax_explain))):
        svc.start()
        try:
            res[name] = (_submit_all(svc, clips), dict(svc.stats))
        finally:
            svc.stop()
    return res


def test_service_matches_jax_service(service_results):
    """Each clip's result dict: the JAX service's keys; probabilities 1e-4,
    mask statistics 1e-5, waveforms 2e-4."""
    (got, stats), (want, _) = service_results["port"], service_results["jax"]
    assert stats["requests"] == 6 and stats["batched_rows"] == 6
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in ("pred_original", "pred_relevant", "pred_irrelevant"):
            assert g[k] == pytest.approx(w[k], abs=1e-4), k
        for k in ("mask_mean", "mask_energy_kept"):
            assert g[k] == pytest.approx(w[k], abs=1e-5), k
        for k in ("relevant_wav", "irrelevant_wav"):
            np.testing.assert_allclose(g[k], np.asarray(w[k]), atol=2e-4, err_msg=k)


def test_service_coalesces_and_isolates_padded_rows(pipe, clips):
    """Three concurrent requests inside the linger window: one batch of
    three rows (the fourth a zero pad, delivered to no one), each row's
    result that of a direct explain of the padded batch; a clip served alone
    (three zero rows beside it) gets the same result as beside other clips."""
    svc = api.ExplainService(pipe, batch_size=BATCH, linger_ms=500).start()
    try:
        before = dict(svc.stats)
        three = _submit_all(svc, clips[:3])
        stats = {k: svc.stats[k] - before[k] for k in before}
        assert stats == {"requests": 3, "batches": 1, "batched_rows": 3}
        alone = svc.submit(clips[1])
    finally:
        svc.stop()
    rows = np.zeros((BATCH, 8000), np.float32)
    rows[:3] = clips[:3]
    direct = pipe.explain(rows)
    for i, r in enumerate(three):
        assert r["pred_original"] == pytest.approx(float(direct.probs_clean[i, 0]), abs=1e-6)
        np.testing.assert_allclose(r["relevant_wav"], direct.relevant_wav[i].numpy(), atol=1e-6)
    for k in ("pred_original", "pred_relevant", "pred_irrelevant", "mask_mean",
              "mask_energy_kept"):
        assert alone[k] == pytest.approx(three[1][k], abs=1e-6), k


def _request(port: int, method: str, path: str, body: bytes | None = None,
             headers: dict | None = None) -> tuple[int, dict]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.fixture(scope="module")
def servers(pipe, jpipe, jax_params, jax_explain):
    """The port's and the JAX package's HTTP servers, port 0 each."""
    params = jax.tree.map(jnp.asarray, jax_params)
    started = {"port": api.start_api_server(pipe, port=0, batch_size=BATCH),
               "jax": japi.start_api_server(jpipe, params, port=0, batch_size=BATCH,
                                            explain_fn=jax_explain)}
    yield {name: server.server_address[1] for name, (server, _) in started.items()}
    for server, service in started.values():
        server.shutdown()
        server.server_close()
        service.stop()


def test_http_round_trip_matches_jax_handler(servers, clips):
    """POST /explain to both servers: the same JSON keys, the numbers at the
    slice bars, the WAV payloads within 2e-4 plus one PCM step; ?audio=0
    drops the payloads; /healthz carries the JAX handler's keys."""
    body = wav_to_bytes(clips[0])
    (code, got), (jcode, want) = (_request(servers[n], "POST", "/explain", body)
                                  for n in ("port", "jax"))
    assert code == jcode == 200
    assert got.keys() == want.keys()
    for k in ("pred_original", "pred_relevant", "pred_irrelevant"):
        assert got[k] == pytest.approx(want[k], abs=1e-4), k
    for k in ("mask_mean", "mask_energy_kept"):
        assert got[k] == pytest.approx(want[k], abs=1e-5), k
    for k in ("relevant_wav_b64", "irrelevant_wav_b64"):
        a, sr = decode_wav_bytes(base64.b64decode(got[k]))
        b, _ = decode_wav_bytes(base64.b64decode(want[k]))
        assert sr == 16000 and a.shape == b.shape == (8000,)
        np.testing.assert_allclose(a, b, atol=2e-4 + PCM_STEP, err_msg=k)
    code, brief = _request(servers["port"], "POST", "/explain?audio=0", body)
    assert code == 200 and set(brief) == set(got) - {"relevant_wav_b64", "irrelevant_wav_b64"}
    (code, health), (jcode, jhealth) = (_request(servers[n], "GET", "/healthz")
                                        for n in ("port", "jax"))
    assert code == jcode == 200 and health.keys() == jhealth.keys()
    assert health["platform"] == "cpu" and health["batch_size"] == BATCH


@pytest.mark.parametrize("case", ["bad_payload", "oversized", "unknown_path"])
def test_error_paths_match_jax_handler(servers, case):
    """400 on a body that is no WAV, 413 above MAX_REQUEST_BYTES (refused
    before the body is read), 404 elsewhere: as the JAX handler answers."""
    assert api.MAX_REQUEST_BYTES == japi.MAX_REQUEST_BYTES
    method, path, body, headers, want = {
        "bad_payload": ("POST", "/explain", b"not a wav", None, 400),
        "oversized": ("POST", "/explain", b"",
                      {"Content-Length": str(api.MAX_REQUEST_BYTES + 1)}, 413),
        "unknown_path": ("GET", "/nope", None, None, 404),
    }[case]
    codes = [_request(servers[n], method, path, body, headers)[0] for n in ("port", "jax")]
    assert codes == [want, want]
