"""Open-loop HTTP load for the live explain API, in a process of its own:

    python3 portbench/loadgen.py --port P --pool FILE.npy --rate R --seconds S \
        --seed N --clients C --sample K --drain D --out FILE

The pool is [N, samples] int16 PCM; each request POSTs one pool clip as a
16-bit mono WAV to `/explain` (audio in the reply). Arrivals: the
`round(R * S)` gaps are the exponential distribution's quantiles at
(i + 1/2) / n, so every seed offers the same gaps, in an order and over
clips shuffled by the seed. Each request is sent at its due time by one of
`clients` threads; its latency runs from its due time to the last byte of
its reply, so a stall also delays the requests due behind it. The process
prints READY, waits for a line on standard input, then starts the clock.

The result file holds, per request: the clip, due, sent and done times (s
from the start), the HTTP status; the replies of `sample` requests drawn
from the seed; and how late the sender ran.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import http.client
import io
import json
import math
import random
import sys
import time
import wave

import numpy as np


def wav_bytes(pcm: np.ndarray, sample_rate: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.astype("<i2").tobytes())
    return buf.getvalue()


def schedule(rate: float, seconds: float, n_clips: int, seed: int) -> list:
    """[(due s, clip)]: the same gaps for every seed, shuffled by it."""
    n = max(1, round(rate * seconds))
    gaps = [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
    rng = random.Random(seed)
    rng.shuffle(gaps)
    order = [i % n_clips for i in range(n)]
    rng.shuffle(order)
    due, out = 0.0, []
    for gap, clip in zip(gaps, order):
        due += gap
        out.append((due, clip))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    for name, kind in (("port", int), ("pool", str), ("rate", float), ("seconds", float),
                       ("seed", int), ("clients", int), ("sample", int), ("drain", float),
                       ("out", str), ("sample-rate", int)):
        ap.add_argument(f"--{name}", type=kind, required=name != "sample-rate")
    args = ap.parse_args(argv)
    pool = np.load(args.pool)
    bodies = [wav_bytes(p, args.sample_rate or 16000) for p in pool]
    plan = schedule(args.rate, args.seconds, len(bodies), args.seed)
    n_sampled = min(args.sample, len(plan))
    sampled = set(random.Random(args.seed + 1).sample(range(len(plan)), n_sampled))
    print("READY", flush=True)
    sys.stdin.readline()

    t0 = time.perf_counter()
    records = [None] * len(plan)

    def send(k: int) -> None:
        due, clip = plan[k]
        sent = time.perf_counter() - t0
        status, body = -1, b""
        try:
            conn = http.client.HTTPConnection("127.0.0.1", args.port, timeout=args.drain)
            try:
                conn.request("POST", "/explain", bodies[clip], {"Content-Type": "audio/wav"})
                resp = conn.getresponse()
                body = resp.read()
                status = resp.status
            finally:
                conn.close()
        except (OSError, http.client.HTTPException) as e:
            body = repr(e).encode()
        done = time.perf_counter() - t0
        records[k] = {"clip": clip, "due": due, "sent": sent, "done": done, "status": status,
                      "reply": json.loads(body) if k in sampled and status == 200 else None}

    late = []
    with cf.ThreadPoolExecutor(max_workers=args.clients) as pool_ex:
        futures = []
        for k, (due, _) in enumerate(plan):
            wait = due - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(wait)
            late.append(time.perf_counter() - t0 - due)
            futures.append(pool_ex.submit(send, k))
        last_due = plan[-1][0]
        outstanding = sum(not f.done() for f in futures)
        cf.wait(futures, timeout=args.drain)
        for f in futures:
            if f.done() and f.exception() is not None:
                raise f.exception()
    late.sort()
    with open(args.out, "w") as f:
        json.dump({"records": records, "window_s": last_due, "outstanding_at_end": outstanding,
                   "late_p95_s": late[int(0.95 * (len(late) - 1))], "late_max_s": late[-1]}, f)
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
