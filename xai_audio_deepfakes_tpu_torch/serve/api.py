"""Live explanation API (port of the JAX package's `serve/api.py`): the
online-serving counterpart to the static gallery (`serve/viewer.py`).

  * ONE explain at a fixed batch size: concurrent requests are coalesced
    (up to `batch_size`, within a `linger_ms` window) into one call; a short
    batch is padded with zero rows to the same shape, so the kernels always
    see the shapes the warm-up batch gave them.
  * ONE worker thread owns the card: HTTP handler threads (stdlib
    `ThreadingHTTPServer`) block on a per-request mailbox while the worker
    runs the batches, so the device is never driven from two threads.
  * Each output of a batch comes to the host once; each row's statistics
    are taken there in numpy, as in the JAX package.
  * Spans (`utils/profiling.py`): on a handler thread `serve.request` (the
    handler's start to the reply written) around `serve.decode` and
    `serve.encode`; `serve.queue` from a request's put to the worker's get,
    under the submitting thread's id; on the worker `serve.linger` (the
    first get to the batch's close), `serve.explain`, `serve.host_copy`,
    `serve.rows`; the counter `serve.queue_depth` (requests waiting when a
    batch starts).

`pipe` is an `ADDvisorPipeline` or a loaded serving artifact
(`serve/export.py::ExportedExplain`): the service reads its clip contract
(`pipe.cfg.audio`) and its device. `explain_fn(wav)` (wav [batch_size,
num_samples] f32 on that device, returning the `ExplainOutput` fields in
their order) replaces the pipeline's explain; the port's pipeline owns its
weights, so the JAX `params` argument has no counterpart.

Endpoints:
  GET  /healthz           -> {"status": "ok", "platform", "batch_size", ...}
  POST /explain           body = WAV bytes -> JSON with the three detector
                          probabilities, mask statistics, and base64 WAV
                          payloads of the relevant/irrelevant reconstructions
                          (`?audio=0` omits the audio payloads).
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from xai_audio_deepfakes_tpu_torch.utils.profiling import count, interval, span

# Upper bound on a single POST body (see `_read_clip`): keeps one malicious or
# accidental multi-GB upload from being buffered into RAM.
MAX_REQUEST_BYTES = 32 * 1024 * 1024


@dataclass
class _Request:
    wav: np.ndarray
    thread: int  # the submitting thread's id and the put's epoch ns (`serve.queue`)
    put_ns: int
    mailbox: "queue.Queue[dict | Exception]" = field(
        default_factory=lambda: queue.Queue(maxsize=1)
    )


class ExplainService:
    """Micro-batching wrapper around one explain.

    `submit(wav)` blocks until the request's batch has run on the device and
    returns a plain-numpy result dict. A single worker thread owns the
    device; `stats` counts requests against batches so tests (and
    dashboards) can see the coalescing ratio.
    """

    def __init__(
        self,
        pipe,
        batch_size: int = 8,
        linger_ms: float = 5.0,
        decoder: str = "unet",
        explain_fn=None,
    ):
        self.pipe = pipe
        self.device = torch.device(pipe.device)
        self.batch_size = int(batch_size)
        self.linger_s = float(linger_ms) / 1e3
        self.decoder = decoder
        # explain_fn overrides the pipeline's explain, e.g. a loaded
        # artifact (`serve/export.py`) serving with no model code at all
        self._explain = explain_fn or (lambda wav: pipe.explain(wav, decoder=decoder))
        self._queue: "queue.Queue[_Request | None]" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "batched_rows": 0}
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._started = False
        self._lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------

    def start(self, warmup: bool = True) -> "ExplainService":
        with self._lock:
            if self._started:
                return self
            if warmup:
                n = self.pipe.cfg.audio.num_samples
                zeros = np.zeros((self.batch_size, n), np.float32)
                self._host(self._run_batch(zeros))  # first launches before traffic
            self._worker.start()
            self._started = True
        return self

    def stop(self) -> None:
        if self._started:
            self._queue.put(None)
            self._worker.join(timeout=30)
            self._started = False

    # -- request path -------------------------------------------------------

    def submit(self, wav: np.ndarray, timeout: float | None = 60.0) -> dict:
        """wav: [num_samples] float32 (already clip-normalized). Blocks until
        the coalesced batch completes; raises on worker-side failure."""
        req = _Request(np.asarray(wav, np.float32), threading.get_ident(), time.time_ns())
        self._queue.put(req)
        try:
            out = req.mailbox.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(
                f"explain batch did not complete within {timeout}s "
                "(device stall, or first-call kernel build cost: warm the "
                "service before accepting traffic)"
            ) from None
        if isinstance(out, Exception):
            raise out
        return out

    # -- worker -------------------------------------------------------------

    def _run_batch(self, wavs: np.ndarray):
        with torch.inference_mode():
            return self._explain(torch.from_numpy(wavs).to(self.device))

    @staticmethod
    def _host(out) -> list[np.ndarray]:
        """The seven outputs the rows need, each copied to the host once:
        mask, magnitude, relevant and irrelevant wavs, three probabilities
        (`ExplainOutput`'s order, phase skipped)."""
        mask, mag, _, rel, irr, p_clean, p_rel, p_irr = out
        return [t.float().cpu().numpy() for t in (mask, mag, rel, irr, p_clean, p_rel, p_irr)]

    def _run(self) -> None:
        while True:
            first = self._queue.get()
            if first is None:
                return
            with span("serve.linger", device=False):
                interval("serve.queue", first.put_ns, first.thread)
                batch = [first]
                deadline = time.monotonic() + self.linger_s
                while len(batch) < self.batch_size:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self._queue.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if nxt is None:
                        self._queue.put(None)  # re-post shutdown for after flush
                        break
                    interval("serve.queue", nxt.put_ns, nxt.thread)
                    batch.append(nxt)
            try:
                self._dispatch(batch)
            except Exception as e:  # deliver failure to every waiter
                for req in batch:
                    req.mailbox.put(e)

    def _dispatch(self, batch: list[_Request]) -> None:
        count("serve.queue_depth", self._queue.qsize())
        with span("serve.explain"):
            n = self.pipe.cfg.audio.num_samples
            rows = np.zeros((self.batch_size, n), np.float32)
            for i, req in enumerate(batch):
                rows[i] = req.wav
            out = self._run_batch(rows)
        with span("serve.host_copy"):
            mask, mag, rel, irr, p_clean, p_rel, p_irr = self._host(out)
        with span("serve.rows", device=False):
            self.stats["requests"] += len(batch)
            self.stats["batches"] += 1
            self.stats["batched_rows"] += len(batch)
            for i, req in enumerate(batch):
                req.mailbox.put(
                    {
                        "pred_original": float(p_clean[i, 0]),
                        "pred_relevant": float(p_rel[i, 0]),
                        "pred_irrelevant": float(p_irr[i, 0]),
                        "mask_mean": float(mask[i].mean()),
                        "mask_energy_kept": float(
                            ((mask[i] * mag[i]) ** 2).sum()
                            / max(float((mag[i] ** 2).sum()), 1e-12)
                        ),
                        "relevant_wav": rel[i],
                        "irrelevant_wav": irr[i],
                    }
                )


def make_handler(service: ExplainService):
    import http.server

    from xai_audio_deepfakes_tpu_torch.data.io import load_audio_bytes, wav_to_bytes

    sr = service.pipe.cfg.audio.sample_rate
    clip_s = service.pipe.cfg.audio.clip_seconds

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.split("?")[0] == "/healthz":
                self._json(
                    200,
                    {
                        "status": "ok",
                        "platform": "gpu" if service.device.type == "cuda" else "cpu",
                        "batch_size": service.batch_size,
                        "decoder": service.decoder,
                        "stats": dict(service.stats),
                    },
                )
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            with span("serve.request", device=False):
                self._explain()

        def _read_clip(self):
            """The body's clip, or None after an error reply."""
            try:
                length = int(self.headers.get("Content-Length", "0"))
                # a clip is <=160 KB of 16-bit PCM at the 5 s contract; 32 MiB
                # comfortably covers any sane container/rate without letting a
                # single POST buffer gigabytes in RAM
                if length > MAX_REQUEST_BYTES:
                    self._json(
                        413,
                        {
                            "error": "payload too large: "
                            f"{length} > {MAX_REQUEST_BYTES} bytes"
                        },
                    )
                    return None
                raw = self.rfile.read(length)
                return load_audio_bytes(raw, target_sr=sr, clip_seconds=clip_s)[0]
            except Exception as e:
                self._json(400, {"error": f"bad wav payload: {e}"})
                return None

        def _explain(self):
            path, _, query = self.path.partition("?")
            if path != "/explain":
                self._json(404, {"error": "not found"})
                return
            want_audio = "audio=0" not in query
            with span("serve.decode", device=False):
                wav = self._read_clip()
            if wav is None:
                return
            try:
                res = service.submit(wav)
            except Exception as e:
                self._json(500, {"error": str(e)})
                return
            with span("serve.encode", device=False):
                payload: dict[str, Any] = {
                    k: res[k]
                    for k in (
                        "pred_original",
                        "pred_relevant",
                        "pred_irrelevant",
                        "mask_mean",
                        "mask_energy_kept",
                    )
                }
                if want_audio:
                    payload["relevant_wav_b64"] = base64.b64encode(
                        wav_to_bytes(res["relevant_wav"], sr)
                    ).decode()
                    payload["irrelevant_wav_b64"] = base64.b64encode(
                        wav_to_bytes(res["irrelevant_wav"], sr)
                    ).decode()
                self._json(200, payload)

    return Handler


def _server(pipe, port, batch_size, linger_ms, decoder, explain_fn):
    """The warmed-up service and an HTTP server bound to `port` over it."""
    import http.server

    service = ExplainService(
        pipe, batch_size=batch_size, linger_ms=linger_ms,
        decoder=decoder, explain_fn=explain_fn,
    ).start()
    server = http.server.ThreadingHTTPServer(("0.0.0.0", port), make_handler(service))
    return server, service


def serve_api(
    pipe,
    port: int = 8080,
    batch_size: int = 8,
    linger_ms: float = 5.0,
    decoder: str = "unet",
    explain_fn=None,
):
    """Blocking server entry point (used by `cli serve-api`); tests and
    scripts start one with `start_api_server` instead."""
    server, service = _server(pipe, port, batch_size, linger_ms, decoder, explain_fn)
    print(
        f"explain API on http://0.0.0.0:{server.server_address[1]} "
        f"(batch={batch_size}, linger={linger_ms}ms, decoder={decoder})",
        flush=True,
    )
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.stop()


def start_api_server(
    pipe,
    port: int = 0,
    batch_size: int = 8,
    linger_ms: float = 5.0,
    decoder: str = "unet",
    explain_fn=None,
):
    """Non-blocking: run the warm-up batch, start the batcher and HTTP server
    threads, return (ThreadingHTTPServer, ExplainService)."""
    server, service = _server(pipe, port, batch_size, linger_ms, decoder, explain_fn)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, service
