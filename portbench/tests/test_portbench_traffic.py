"""The traffic is fixed by the seed: the same seed gives the same clips,
another seed other clips of the same sizes."""

from __future__ import annotations

import torch

from portbench import clips, harness
from portbench import cellkit

P = harness.cell_files("entry-offline")[2]["clips"]
BIG = 2**31 + 12345


def _clips(seed, n=3, samples=4000):
    return clips.speechlike(torch.Generator().manual_seed(seed), n, samples, 16000, P, "cpu")


def test_same_seed_same_clips():
    a, b = _clips(BIG), _clips(BIG)
    assert torch.equal(a, b)
    assert a.shape == (3, 4000) and torch.isfinite(a).all()


def test_other_seed_other_clips_same_sizes():
    a, b = _clips(BIG), _clips(BIG + 1)
    assert a.shape == b.shape and not torch.equal(a, b)


def test_clips_are_speech_like():
    a = _clips(7, n=4, samples=16000)
    peak = a.abs().amax(dim=1)
    assert bool(((peak > 0.2) & (peak < 0.5)).all())
    spec = torch.fft.rfft(a, dim=1).abs()
    # the energy sits below the harmonic ceiling, above the noise floor
    assert bool((spec[:, :7600].pow(2).sum(1) > 0.95 * spec.pow(2).sum(1)).all())


def test_pool_is_fixed_by_the_seed():
    _, cfg, traffic = harness.cell_files("entry-offline")
    p = dict(cfg["pipeline"], audio=dict(cfg["pipeline"]["audio"], clip_seconds=0.25))
    t = dict(traffic, batch=2, pool_batches=2)
    a = cellkit.make_pool(p, t, BIG, "cpu")
    assert a.shape == (2, 2, 4000)
    assert torch.equal(a, cellkit.make_pool(p, t, BIG, "cpu"))
