"""Driver resilience (port of `utils/resilience.py`): a pre-flight device
probe, and retrying subprocess attempts with diagnostics.

  * `device_preflight()` runs a tiny product on the card and copies the
    result to the host, proving the device is alive before a long run
    starts; its failure is retried once, since transient faults often
    clear within seconds.
  * `run_attempts()` runs a command as a sequence of fresh-subprocess
    attempts with per-attempt environment overrides, parses one JSON
    result line from stdout and `BENCH_PHASE <name>` progress markers from
    stderr, and returns a machine-readable record of every attempt whether
    or not one succeeded.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

PHASE_PREFIX = "BENCH_PHASE "


def phase(name: str) -> None:
    """Mark progress from inside a measured subprocess. The outer driver
    collects these from stderr so a crash still records how far the run
    got (imports / params / compile+warmup / measure / done)."""
    print(PHASE_PREFIX + name, file=sys.stderr, flush=True)


def device_preflight(device="cuda", retries: int = 1, retry_wait_s: float = 10.0) -> dict:
    """Prove the device can run a kernel and return data to the host: a
    128 x 128 bf16 product, summed in f32 and copied to the host.

    Runs in-process (callers that want isolation run it through a
    subprocess attempt). Returns {"device", "value"}; raises the last error
    after `retries` re-attempts. Without CUDA it raises unless the caller
    asks for `device="cpu"`: it never falls back to the CPU."""
    import torch

    from xai_audio_deepfakes_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    last = None
    for i in range(retries + 1):
        try:
            x = torch.full((128, 128), 1.0, dtype=torch.bfloat16, device=dev)
            value = float((x @ x).float().sum().cpu())
            name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)
            return {"device": name, "value": value}
        except Exception as e:  # noqa: BLE001 — any device error qualifies
            last = e
            if i < retries:
                time.sleep(retry_wait_s)
    raise last


def _parse_result_line(stdout: str):
    """Last stdout line that parses as a JSON object, else None."""
    for line in reversed(stdout.strip().splitlines()):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict):
            return obj
    return None


def run_attempts(
    cmd: list[str],
    attempts: list[tuple[str, dict]],
    timeout_s: float = 2700.0,
    stderr_tail_lines: int = 12,
) -> tuple[dict | None, list[dict]]:
    """Run `cmd` once per (label, env_extra) attempt until one succeeds.

    Success = exit code 0 AND a JSON object line on stdout. Each attempt is
    a fresh subprocess (a wedged device context or a poisoned cache entry
    cannot leak into the next try). Returns (result_or_None, attempt
    records); each record carries label, env overrides, rc, phases reached,
    wall seconds, and the stderr tail on failure.
    """
    records: list[dict] = []
    for label, env_extra in attempts:
        env = dict(os.environ)
        env.update({k: str(v) for k, v in env_extra.items()})
        t0 = time.perf_counter()
        rec: dict = {"label": label, "env": dict(env_extra)}
        try:
            proc = subprocess.run(
                cmd,
                capture_output=True,
                text=True,
                env=env,
                timeout=timeout_s,
            )
            rc, out, err = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc = -1
            out = (e.stdout or b"").decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
            err = (e.stderr or b"").decode() if isinstance(e.stderr, bytes) else (e.stderr or "")
            err += f"\n[run_attempts] timeout after {timeout_s}s"
        rec["rc"] = rc
        rec["seconds"] = round(time.perf_counter() - t0, 3)
        rec["phases"] = [
            ln[len(PHASE_PREFIX):].strip()
            for ln in err.splitlines()
            if ln.startswith(PHASE_PREFIX)
        ]
        result = _parse_result_line(out) if rc == 0 else None
        if result is not None:
            rec["ok"] = True
            records.append(rec)
            return result, records
        rec["ok"] = False
        rec["stderr_tail"] = "\n".join(
            ln for ln in err.splitlines() if not ln.startswith(PHASE_PREFIX)
        )[-4000:].splitlines()[-stderr_tail_lines:]
        records.append(rec)
    return None, records
