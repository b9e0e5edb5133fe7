"""`chip_smoke.py`'s card checks as pure functions, held on the CPU: the
weight seeds the tiny int8 explains are held at, the bars check (ii) takes
at each seed, the per-draw bar computed from the CPU's one-step deviation,
and the rotation behind B's and C's cold times. Imports nothing of JAX.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import chip_smoke as cs


def test_tiny_seeds_are_the_eight():
    assert cs.TINY_SEEDS == (5, 101, 102, 103, 104, 105, 106, 107)
    assert cs.CODE_STEP_BOUND == 3


@pytest.mark.parametrize("key", ("probs",) + cs.EXPLAIN_KEYS)
def test_check_ii_bars_per_seed(key):
    """Seed 5 keeps the bf16 bars it was held at; a bf16 UNet's outputs also
    take the per-draw bar there, and only it at the other seeds; the
    probabilities and every other UNet keep the bf16 bars at every seed."""
    for seed in cs.TINY_SEEDS:
        assert cs.ii_bars(seed, False, key) == ("0.4x",)
        if key == "probs":
            assert cs.ii_bars(seed, True, key) == ("0.4x",)
        elif seed == 5:
            assert cs.ii_bars(seed, True, key) == ("0.4x", "per_draw")
        else:
            assert cs.ii_bars(seed, True, key) == ("per_draw",)


def test_seed_5_bf16_bars_unchanged():
    """The bf16 bars as they were: mean |got - want| at most 0.4x the mean of
    the own bf16-vs-f32 deviation, max at most the larger of its max and
    two bf16 steps at max |want|."""
    want = torch.tensor([1.0, -0.5, 0.25, 2.0])
    want_f32 = want + torch.tensor([0.0625, -0.125, 0.0, 0.0])  # own mean 0.046875, max 0.125
    two_steps = 2.0 ** (1 - 6)  # max |want| 2 is in [2, 4): a bf16 step is 2^-6
    ok, _, nums = cs.bf16_bars(want + torch.tensor([0.0, 0.0, 0.0, 0.07]), want, want_f32)
    assert ok and nums["mean"] == pytest.approx(0.07 / 4, rel=1e-5)
    assert nums["mean_bar"] == pytest.approx(0.4 * 0.046875) and nums["max_bar"] == 0.125
    assert not cs.bf16_bars(want + torch.tensor([0.0, 0.0, 0.0, 0.08]), want, want_f32)[0]
    # the max bar: two bf16 steps where the own deviation's max is smaller
    small = want + torch.tensor([0.0, 0.0, 0.0, 2.0**-10])
    got = want + torch.tensor([0.0, 0.0, 0.0, two_steps])
    ok, _, nums = cs.bf16_bars(got, want, small)
    assert nums["max_bar"] == two_steps and nums["max"] <= two_steps
    assert not ok  # the mean, 2^-7, is over 0.4 * 2^-12
    assert not cs.bf16_bars(torch.tensor([float("nan")] * 4), want, want_f32)[0]


def test_per_draw_bar_from_the_one_step_deviation():
    base = torch.zeros(4)
    moved = [torch.tensor([0.1, 0.0, 0.0, 0.0]), torch.tensor([0.0, 0.05, -0.05, 0.0])]
    mean_bar, max_bar = cs.per_draw_bar(base, moved)
    assert mean_bar == pytest.approx(2 * 0.025) and max_bar == pytest.approx(2 * 0.1)
    assert cs.per_draw_bar(base, moved, margin=1.0) == pytest.approx((0.025, 0.1))
    ok, line, nums = cs.per_draw_bars(torch.tensor([0.04, 0.0, 0.0, -0.04]), base, moved)
    assert ok and "ok" in line and nums["mean"] == pytest.approx(0.02)
    assert not cs.per_draw_bars(torch.tensor([0.21, 0.0, 0.0, 0.0]), base, moved)[0]  # max
    assert not cs.per_draw_bars(torch.full((4,), 0.06), base, moved)[0]  # mean
    assert not cs.per_draw_bars(torch.tensor([float("inf"), 0.0, 0.0, 0.0]), base, moved)[0]


def test_bf16_step_moved():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    x[:3] = torch.tensor([0.0, -0.0, 1e-40])
    moved = cs.bf16_step_moved(x, 0)
    assert moved.dtype == torch.float32 and torch.equal(moved.to(torch.bfloat16).float(), moved)
    steps = (moved.to(torch.bfloat16).view(torch.int16).int()
             - x.to(torch.bfloat16).view(torch.int16).int())
    assert bool((steps.abs() == 1).all())
    assert bool((torch.signbit(moved) == torch.signbit(x)).all())
    up = moved.abs() > x.to(torch.bfloat16).float().abs()
    assert 0.4 < float(up.float().mean()) < 0.6 and bool(up[:2].all())
    assert torch.equal(cs.bf16_step_moved(x, 0), moved)
    assert not torch.equal(cs.bf16_step_moved(x, 1), moved)


def test_cold_rotation():
    """B's and C's cold times: at least 8 distinct sets and more bytes than
    L2; each call takes the next set and keeps its output until that set
    comes round again."""
    assert cs.cold_sets(4 * (8 * 80000 + 2 * 8 * 513 * 249)) == 8  # 10.74 MB a call
    assert cs.cold_sets(1e6) == 53 and 53 * 1e6 > cs.L2_BYTES
    assert cs.cold_sets(1e8) == cs.COLD_SETS

    class Out:
        pass

    seen, refs = [], []

    def fn(i):
        seen.append(i)
        out = Out()
        refs.append(weakref.ref(out))
        return out

    call = cs.rotating(fn, [(i,) for i in range(3)])
    for _ in range(7):
        call()
    gc.collect()
    assert seen == [0, 1, 2, 0, 1, 2, 0]
    assert [r() is not None for r in refs] == [False] * 4 + [True] * 3
