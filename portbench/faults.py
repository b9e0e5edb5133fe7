"""Faults planted under a cell's timed path, to show that `correct` catches
them: each wraps the timed callable (`harness.execute(hook=...)`). The CPU
tests run them on tiny cells; `limits.py` reads them on the card at a cell's
size, where a training cell's limits are held against them."""

from __future__ import annotations

import torch


def half_batch(explain):
    """Half of the batch left out: the first half explained, its outputs
    given for the rest too."""
    def broken(wav):
        half = explain(wav[: wav.shape[0] // 2])
        return half._replace(**{k: torch.cat([v, v])[: wav.shape[0]]
                                for k, v in half._asdict().items()})
    return broken


def mask_altered(explain):
    """An answer altered where it is produced: the first clip's mask
    inverted."""
    def broken(wav):
        out = explain(wav)
        mask = out.mask.clone()
        mask[0] = 1.0 - mask[0]
        return out._replace(mask=mask)
    return broken


def prob_altered(explain):
    """An answer altered where it is produced: the irrelevant clips'
    probabilities flipped."""
    def broken(wav):
        out = explain(wav)
        return out._replace(probs_irrelevant=1.0 - out.probs_irrelevant)
    return broken


EXPLAIN = {"half_batch": half_batch, "mask_altered": mask_altered, "prob_altered": prob_altered}


def _params(state) -> list:
    return list(state.decoder.parameters()) + [state.w_raw]


def state_unchanged(step):
    """A step that returns its state unchanged: it computes, then every
    parameter is put back."""
    def broken(state, wav, *a, **k):
        before = [p.detach().clone() for p in _params(state)]
        out = step(state, wav, *a, **k)
        with torch.no_grad():
            for p, b in zip(_params(state), before):
                p.copy_(b)
        return out
    return broken


def step_half_batch(step):
    """Half of the batch left out, the mean taken over the rest."""
    def broken(state, wav, *a, **k):
        return step(state, wav[: wav.shape[0] // 2], *a, **k)
    return broken


def row_altered(step):
    """An answer altered where it is produced: the batch's first clip
    replaced by its second before the step reads it."""
    def broken(state, wav, *a, **k):
        wav = wav.clone()
        wav[0] = wav[1]
        return step(state, wav, *a, **k)
    return broken


TRAIN = {"state_unchanged": state_unchanged, "half_batch": step_half_batch,
         "row_altered": row_altered}
