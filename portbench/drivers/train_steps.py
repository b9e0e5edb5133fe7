"""LMAC training of the UNet decoder: the step of
`train/train_addvisor.py::make_train_step`, called as `train_addvisor`
calls it, over a pool of distinct seeded batches.

Set-up builds one training state (the pipeline's UNet, w_raw and both
optimisers), drives it through its first `checked_steps` steps on the pool's
first batches through the window's own call (the step's first call warms
every shape), and hands the same state to the window. Those steps' losses,
the first gradient as Adam holds it after step 1 (exp_avg / (1 - beta1)) and
the parameters before and after them are kept for the comparison. The
window: steps until `seconds` have passed on the host, their losses kept on
the device with a finiteness probe every `nan_check_every` steps as
`train_addvisor` does, then a synchronise; the rate counts the clips of
every step whose update completed, over the time to that synchronise. With
`--trace 1`, `trace_steps` more steps run under the profiler, with CUDA
events at the step's phase marks.

After the window the pipeline is freed and the plain reference
(`reference/train.py`) trains its own copy of the same weights through the
same first batches.
"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from portbench import tracing, weights
from portbench.check import TRAIN_NUMBERS as NUMBERS
from portbench.cellkit import make_pool, pipeline_config, prepared_weights
from portbench.reference import explain as ref_explain
from portbench.reference import train as ref_train

def snapshot(state) -> dict:
    out = {n: p.detach().float().clone() for n, p in state.decoder.named_parameters()}
    out["w_raw"] = state.w_raw.detach().float().clone()
    return out


def first_gradient(state) -> dict:
    beta1 = state.opt_model.defaults["betas"][0]
    out = {}
    for n, p in state.decoder.named_parameters():
        out[n] = state.opt_model.state[p]["exp_avg"].float() / (1.0 - beta1)
    out["w_raw"] = state.opt_w.state[state.w_raw]["exp_avg"].float() / (1.0 - beta1)
    return out


def norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def first_steps(step, state, pool: torch.Tensor, n: int, after=lambda i: None) -> dict:
    """The program's readings of its first `n` steps, each on its own pool
    batch: {"losses", "grad" (leaf norms of the first gradient), "change"
    (leaf norms of the parameters' change)}; `after(i)` runs after step i."""
    p0 = snapshot(state)
    losses, grad = [], None
    for i in range(n):
        _, aux = step(state, pool[i])
        losses.append(float(aux["loss"]))
        grad = norms(first_gradient(state)) if grad is None else grad
        after(i)
    p3 = snapshot(state)
    return {"losses": losses, "grad": grad, "change": norms({k: p3[k] - p0[k] for k in p0})}


def leaf_gap(got: dict, want: dict, keep: list) -> float:
    """The worst leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and its median leaf's."""
    med = statistics.median(want[k] for k in keep)
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keep)


def compare(prog: dict, ref: dict) -> dict:
    """prog / ref: {"losses": [per step], "grad": {leaf: norm}, "change":
    {leaf: norm}}. Leaves whose reference gradient is under a thousandth of
    the median leaf's (a conv bias ahead of a BatchNorm, whose batch mean
    removes it) move by round-off alone and are left out."""
    med = statistics.median(ref["grad"].values())
    keep = [k for k, g in ref["grad"].items() if g >= 1e-3 * med]
    if len(prog["losses"]) != len(ref["losses"]) or set(prog["grad"]) != set(ref["grad"]):
        return {k: float("inf") for k in NUMBERS}
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))
    return {"loss_rel_gap": loss, "grad_norm_gap": leaf_gap(prog["grad"], ref["grad"], keep),
            "change_norm_gap": leaf_gap(prog["change"], ref["change"], keep),
            "leaves_left_out": len(ref["grad"]) - len(keep)}


def reference_readings(w: dict, pool: torch.Tensor, cfg: dict, steps: int,
                       control: bool = False) -> dict:
    tr = ref_train.Trainer(w, cfg, cfg["loss"], cfg["train"], control=control)
    before = {k: v.detach().clone() for k, v in tr.parameters().items()}
    losses, grad = [], None
    with ref_explain.precise():
        for i in range(steps):
            out = tr.step(pool[i])
            losses.append(out["loss"])
            grad = norms(out["grads"]) if grad is None else grad
    change = norms({k: v.detach() - before[k] for k, v in tr.parameters().items()})
    return {"losses": losses, "grad": grad, "change": change}


class _Marks:
    """The step's `mark` hook: CUDA events at each phase while on."""

    def __init__(self):
        self.on, self.events = False, []

    def __call__(self, name: str) -> None:
        if self.on:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append((name, ev))

    def collate_ms(self) -> float | None:
        spans = [a[1].elapsed_time(b[1]) for a, b in zip(self.events, self.events[1:])
                 if a[0] == "start" and b[0] == "collate"]
        return sum(spans) / len(spans) if spans else None


def run(run) -> dict:
    from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline
    from xai_audio_deepfakes_tpu_torch.train.train_addvisor import (
        init_train_state,
        make_train_step,
    )

    cfg, traffic, dev = run.cfg["pipeline"], run.traffic, run.device
    b, n_pool, checked = traffic["batch"], traffic["pool_batches"], traffic["checked_steps"]
    if n_pool <= checked:
        raise ValueError("the checked steps take distinct batches: pool_batches > checked_steps")
    marks = [("start", run.since_start())]
    pipe = ADDvisorPipeline(pipeline_config(cfg), device=dev, seed=0)
    w = prepared_weights(run.cfg, traffic, run.seed, dev)
    weights.load_into(pipe, w)
    w = weights.to(w, "cpu")
    pool = make_pool(cfg, traffic, run.seed, dev)
    marks.append(("weights, pool", run.since_start()))
    run.reset_peak()
    state = init_train_state(pipe)
    mark = _Marks() if run.cuda else None
    step = run.hook(make_train_step(pipe, mark=mark))
    prog = first_steps(step, state, pool, checked,
                       lambda i: marks.append((f"step {i + 1}", run.since_start())))
    run.sync()
    setup_s = run.since_start()

    nan_every = cfg["train"]["nan_check_every"]
    done, vecs = 0, []
    smi_before = run.smi()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds or done == 0:
        _, aux = step(state, pool[(checked + done) % n_pool])
        vecs.append(aux["loss_vec"])
        done += 1
        probe = nan_every and done % nan_every == 0
        if probe and not bool(torch.isfinite(torch.stack(vecs)).all()):
            raise FloatingPointError(f"non-finite loss by window step {done}")
    run.sync()
    elapsed = time.perf_counter() - t0
    finite = bool(torch.isfinite(torch.stack(vecs)).all())
    smi_after = run.smi()

    trace, collate_ms = None, None
    if run.trace:
        got: dict = {}
        k = traffic["trace_steps"]
        with tracing.profiled(got, run.cuda):
            if mark is not None:
                mark.on = True
            for i in range(k):
                if mark is not None:
                    mark("start")
                step(state, pool[(checked + done + i) % n_pool])
        if mark is not None:
            mark.on = False
            collate_ms = mark.collate_ms()
        trace = tracing.Trace(got["prof"], got["wall_s"], k)
        run.save_trace(got["prof"])
    peak = run.peak()

    del pipe, state, step
    gc.collect()
    run.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_readings(weights.to(w, dev), pool, cfg, checked)
    numbers = compare(prog, ref) if finite else {k: float("inf") for k in NUMBERS}
    log = ["set-up marks (s since start): " + ", ".join(f"{k} {v:.3f}" for k, v in marks),
           f"reference: {time.perf_counter() - t_ref:.3f} s; window {elapsed:.3f} s, {done} steps",
           f"losses program {prog['losses']} reference {ref['losses']}",
           f"leaves left out of the gradient and change comparison: "
           f"{numbers.pop('leaves_left_out', 'all')}",
           f"card (sm clock, power, temperature) before the window: {smi_before}; "
           f"after: {smi_after}"]
    return {
        "attempted": done * b,
        "failed": 0 if finite else done * b,
        "end_to_end": {"train_clips_per_s": done * b / elapsed, "setup_s": setup_s},
        "window": {"units": done, "clips": done * b, "seconds": elapsed, "batch": b,
                   "collate_ms": collate_ms},
        "trace": trace,
        "memory_peak_bytes": peak,
        "numbers": numbers,
        "log": log,
    }
