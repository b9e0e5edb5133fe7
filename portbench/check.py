"""The comparison that decides `correct`: the program's outputs against the
plain reference's on the same inputs and weights, each number beside the
limit the configuration file states for it.

Numbers of an explain (over every compared clip):
  * `mask_max_abs`: the largest |mask - reference mask|;
  * `wav_rel_l2`: the largest ||wav - reference|| / ||reference|| over the
    relevant and the irrelevant waveform of each clip;
  * `prob_max_abs`: the largest |p - reference p| over the three
    probabilities of each clip.
A number that is not finite, or an output of the wrong shape, reads inf.
"""

from __future__ import annotations

import math

import numpy as np

EXPLAIN_NUMBERS = ("mask_max_abs", "wav_rel_l2", "prob_max_abs")
# a served reply: its mask statistics (mean, energy kept) in place of the mask
SERVE_NUMBERS = ("mask_stats_max_abs", "wav_rel_l2", "prob_max_abs")
# a training cell's first steps (`drivers/train_steps.py::compare`)
TRAIN_NUMBERS = ("loss_rel_gap", "grad_norm_gap", "change_norm_gap")


def _host(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if hasattr(t, "detach") else np.asarray(t, np.float32)


def explain_numbers(got: dict, ref: dict) -> dict:
    """got: the program's outputs of a batch (numpy or tensors, by the
    `ExplainOutput` field names); ref: the reference's -> the numbers."""
    out = {}
    try:
        g, r = _host(got["mask"]), _host(ref["mask"])
        out["mask_max_abs"] = float(np.max(np.abs(g - r))) if g.shape == r.shape else math.inf
        rel = []
        for key in ("relevant_wav", "irrelevant_wav"):
            g, r = _host(got[key]).astype(np.float64), _host(ref[key]).astype(np.float64)
            if g.shape != r.shape:
                rel.append(math.inf)
                continue
            rel.append(float(np.max(np.linalg.norm(g - r, axis=-1)
                                    / np.maximum(np.linalg.norm(r, axis=-1), 1e-30))))
        out["wav_rel_l2"] = max(rel)
        gaps = []
        for key in ("probs_clean", "probs_relevant", "probs_irrelevant"):
            g, r = _host(got[key]), _host(ref[key])
            gaps.append(float(np.max(np.abs(g - r))) if g.shape == r.shape else math.inf)
        out["prob_max_abs"] = max(gaps)
    except KeyError:
        return {k: math.inf for k in EXPLAIN_NUMBERS}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def merge(a: dict, b: dict) -> dict:
    """The worse of two readings of each number."""
    return {k: max(a.get(k, -math.inf), b.get(k, -math.inf)) for k in set(a) | set(b)}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number the
    limits name was read, is finite and is at most its limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        checks[name] = {"value": value if math.isfinite(value) else "inf", "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok and bool(limits), checks
