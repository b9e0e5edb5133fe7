"""PyTorch port, kernel D's plan on the CPU: a numpy emulation of
`csrc/ln_gelu.cu::ln_gelu_kernel` against the kernel's plain version
`ln_gelu_plain`.

The emulation mirrors the kernel's index maps: tiles of all C channels x F
frames of one batch row (128 bytes of each channel row); the persistent
grid's walk, each block taking a contiguous range of tiles, and the runs of
consecutive tiles of one batch row inside it; per channel row a ring of R
16-byte chunks, filled with the row's aligned chunks counted from the 16-byte
block of x's data pointer (so a storage offset moves every residue),
zero-filled past the end of x; the shift of frame l0 within a row, one shift
for all channels of a channel group; the chunk that a tile shares with the
next tile of its run, copied once and stored once by the next tile; the
statistics of thread = frame, channel group g = channels g + 8 i, in the
kernel's summation order; and the stores, one 16-byte chunk where all its
elements are to be stored, element by element at the ends of a run. Memory
is a flat numpy buffer, and the loads of the next tile happen before the
stores of the current one, as on the card, so a test can run in place.

Each case asserts that every output element is stored exactly once, that no
store leaves the tile that owns it (in-place safety: a block reads its
neighbours' frames at the ends of its run and discards them), and, where
values are emulated, that LN + GELU from the staged values equals
`ln_gelu_plain` at the kernel's bars. The kernel itself runs only on the card
(`tests/test_torch_kernels.py`). This file imports nothing of JAX.
"""

import math

import numpy as np
import pytest
import torch

from xai_audio_deepfakes_tpu_torch.ops.cuda_ln_gelu import _empty_at_residue, ln_gelu_plain

GROUPS = 8  # channel groups of a block
MAX_C = 512
SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_PER_SM = 228 * 1024  # shared memory of one SM, of which a block may use 227 KB
FRONTEND_LENGTHS = [15999, 7999, 3999, 1999, 999, 499, 249]
ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}


def frames(item):
    """Frames of a tile, one a thread of a channel group: 128 bytes of a row."""
    return 64 if item == 2 else 32


def vec(item):
    return 16 // item


def fresh(item):
    """Chunks a tile adds to a row's ring."""
    return frames(item) // vec(item)


def ring(item):
    """Chunks of a row's ring."""
    return 2 * fresh(item) + 2


def smem_bytes(c, item):
    """The kernel's dynamic shared memory: C rings, (scale, bias) pairs."""
    return c * ring(item) * 16 + 8 * c


def blocks_per_sm(c, item):
    """Blocks of one SM by shared memory (the static reduction arrays and the
    1 KB the card reserves per block included) and by registers (128 a
    thread, 8 x F threads a block)."""
    by_regs = 65536 // (128 * GROUPS * frames(item))
    return min(by_regs, SMEM_PER_SM // (smem_bytes(c, item) + 2 * GROUPS * 64 * 4 + 1024))


def misalignment(offset, item):
    """Elements between a pointer at `offset` elements into a 16-byte aligned
    buffer and the start of its 16-byte block."""
    return offset * item % 16 // item


def walk(ntiles, ntl, item, per_sm, sms=SMS):
    """The launcher's grid and each block's steps in order: (tile, ring slot
    q of its first chunk, `prev`: it continues a run, so its first chunk is
    in the ring, `cont`: the next tile continues the run, the next tile)."""
    span = -(-ntiles // (per_sm * sms))
    grid = -(-ntiles // span)
    blocks = []
    for blk in range(grid):
        t, q, prev, steps = blk * span, 0, False, []
        while t < ntiles:
            tn = t + 1
            if tn % span == 0:
                tn += (grid - 1) * span
            tn = min(tn, ntiles)
            cont = tn == t + 1 and tn % ntl != 0
            steps.append((t, q, prev, cont, tn))
            q, prev, t = (q + fresh(item) + (0 if cont else 1)) % ring(item), cont, tn
        blocks.append(steps)
    return grid, blocks


def load_chunks(rows, l0, j0, mis, x_len, l, item):
    """issue_tile: [rows, chunks] starts (elements from x's 16-byte block) of
    chunks j0..NEW, and the elements each reads (the rest is zero-filled)."""
    v = vec(item)
    ax = mis + rows * l + l0
    j = np.arange(j0, fresh(item) + 1)
    s = (ax // v * v)[:, None] + v * j
    return j, s, np.clip(mis + x_len - s, 0, v)


def store_mask(rows, l0, nf, prev, defer, mis, l, item):
    """store_tile: chunk j of row r at element (ay - sh + VEC j) from y's
    16-byte block; which elements are stored and their frames (relative to
    l0), and which chunks go as one 16-byte store."""
    v, new = vec(item), fresh(item)
    ay = mis + rows * l + l0
    sh = ay % v
    j = np.arange(new + 1)
    f = (v * j)[None, :, None] - sh[:, None, None] + np.arange(v)
    stored = (f >= (-v if prev else 0)) & (f < nf)
    if defer:
        stored[:, new] = False
    full = stored.all(axis=2)
    start = (ay - sh)[:, None] + v * j
    return start, f, stored, full


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def frame_sum(v, ok, square):
    """frame_sum: thread (g, fr) sums its even and its odd i in four
    interleaved accumulators each (PyTorch's reduction order at C = 512),
    then the channel groups' partial sums meet in a tree."""
    acc = np.zeros((2, 4) + v.shape[1:], np.float32)
    for i in range(v.shape[0]):
        term = v[i] * v[i] if square else v[i]
        acc[i % 2, (i // 2) % 4] += np.where(ok[i][:, None], term, np.float32(0))
    row = ((acc[:, 0] + acc[:, 1]) + acc[:, 2]) + acc[:, 3]
    u = row[0] + row[1]
    return ((u[0] + u[4]) + (u[2] + u[6])) + ((u[1] + u[5]) + (u[3] + u[7]))


def compute_tile(rings, c, pos, scale, bias, eps, gelu, bf16):
    """compute_tile on the rings [c, R VEC]: thread (g, fr) holds frame fr
    of channels g + 8 i, read at ring element pos[g, fr] and written back
    there; every operation of the normalisation rounds to f32."""
    per = MAX_C // GROUPS
    v = np.zeros((per, GROUPS, pos.shape[1]), np.float32)
    ok = np.zeros((per, GROUPS), bool)
    for i in range(per):
        for g in range(GROUPS):
            if g + GROUPS * i < c:
                ok[i, g] = True
                v[i, g] = rings[g + GROUPS * i, pos[g]]
    mu = frame_sum(v, ok, False) / np.float32(c)
    d = v - mu
    rs = np.float32(1) / np.sqrt(frame_sum(d, ok, True) / np.float32(c) + np.float32(eps))
    for i in range(per):
        for g in range(GROUPS):
            ch = g + GROUPS * i
            if ch < c:
                n = d[i, g] * rs * np.float32(scale[ch]) + np.float32(bias[ch])
                n = _bf16(n) if bf16 else n
                y = torch.nn.functional.gelu(torch.from_numpy(n),
                                             approximate="tanh" if gelu == "tanh" else "none")
                rings[ch, pos[g]] = _bf16(y.numpy()) if bf16 else y.numpy()


def run_kernel(buf, x_off, y_off, shape, scale, bias, eps, gelu, dtype, order, sms):
    """The whole launch on the flat buffer `buf` (x at x_off, y at y_off, with
    the same residue modulo 16 bytes; the same offset for in place), block
    after block in the given order, each block's copies of the next tile
    before its stores of the current one. Returns how often each element of
    buf was stored."""
    b, c, l = shape
    item = ITEMSIZE[dtype]
    v, new, r_, F = vec(item), fresh(item), ring(item), frames(item)
    mis = misalignment(x_off, item)
    assert misalignment(y_off, item) == mis
    xa, ya = x_off - mis, y_off - mis
    ntl = math.ceil(l / F)
    _, blocks = walk(b * ntl, ntl, item, blocks_per_sm(c, item), sms)
    count = np.zeros(len(buf), np.int64)
    rows_c = np.arange(c)
    for steps in (blocks[::-1] if order == "reverse" else blocks):
        rings = np.zeros((c, r_, v), np.float32)

        def issue(t, q, j0):
            j, s, n = load_chunks(t // ntl * c + rows_c, t % ntl * F, j0, mis, b * c * l, l, item)
            assert (xa + s >= 0).all()  # never before x's 16-byte block
            for k, jj in enumerate(j):
                chunk = np.zeros((c, v), np.float32)
                for e in range(v):
                    take = n[:, k] > e
                    chunk[take, e] = buf[xa + s[take, k] + e]
                rings[:, (q + jj) % r_] = chunk

        issue(steps[0][0], steps[0][1], 0)
        for t, q, prev, cont, tn in steps:
            if tn < b * ntl:
                issue(tn, (q + new + (0 if cont else 1)) % r_, 1 if cont else 0)
            bi, l0 = t // ntl, t % ntl * F
            row0 = bi * c
            sh = (mis + (row0 + np.arange(GROUPS)) * l + l0) % v
            # one shift for all channels of a group: 8 L is a multiple of VEC
            assert ((mis + (row0 + rows_c) * l + l0) % v == sh[rows_c % GROUPS]).all()
            pos = ((q * v + sh)[:, None] + np.arange(F)) % (r_ * v)
            compute_tile(rings.reshape(c, r_ * v), c, pos, scale, bias, eps, gelu,
                         dtype == torch.bfloat16)
            nf = min(F, l - l0)
            start, f, stored, full = store_mask(row0 + rows_c, l0, nf, prev, cont, mis, l, item)
            assert ((ya + start[full]) * item % 16 == 0).all()  # 16-byte stores are aligned
            # a stored element is this tile's frame, or with prev one of the
            # last frames of the tile before it in this run
            assert ((f[stored] < nf) & (f[stored] >= (-v if prev else 0))).all()
            addr = ya + start[..., None] + np.arange(v)
            buf[addr[stored]] = rings[:, (q + np.arange(new + 1)) % r_][stored]
            np.add.at(count, addr[stored], 1)
    return count


def _inputs(rng, shape, dtype):
    b, c, l = shape
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    x = _bf16(x) if dtype == torch.bfloat16 else x
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,gelu", [((3, 8, 1), "exact"), ((3, 8, 7), "tanh"),
                                        ((3, 8, 9), "exact"), ((3, 8, 249), "exact"),
                                        ((2, 512, 249), "tanh"), ((2, 100, 37), "exact")],
                         ids=["c8_l1", "c8_l7", "c8_l9", "c8_l249", "c512_l249", "c100_l37"])
@pytest.mark.parametrize("offset,in_place,order,sms", [
    (0, True, "walk", SMS), (1, True, "walk", 1), (1, True, "reverse", 1),
    (3, True, "reverse", 2), (1, False, "walk", 1)],
    ids=["in_place", "offset1_runs", "offset1_runs_reverse", "offset3_runs_reverse",
         "offset1_runs_out_of_place"])
def test_plan_matches_plain(rng, dtype, shape, gelu, offset, in_place, order, sms):
    """The emulated launch: each element of y stored once, nothing else in
    the buffer touched, and the values equal to `ln_gelu_plain` (f32 2e-5;
    bf16 1e-2 + 1e-2 |y|, at most 0.1% of the elements more than one bf16
    step off, as on the card). A grid for one or two SMs gives each block
    runs of several tiles, across batch rows. In place, the reverse order of
    blocks makes the ends of every run read their neighbours' outputs."""
    x, scale, bias = _inputs(rng, shape, dtype)
    size = x.size
    # out of place, y lies at the same residue in a 16-byte aligned region after x's
    y_off = offset if in_place else (offset + size + 8) // 8 * 8 + offset
    buf = np.full(y_off + size + 11, 7.0, np.float32)
    buf[offset:offset + size] = x.reshape(-1)
    count = run_kernel(buf, offset, y_off, shape, scale, bias, 1e-5, gelu, dtype, order, sms)
    assert (count[y_off:y_off + size] == 1).all()
    assert count.sum() == size
    want = ln_gelu_plain(torch.from_numpy(x).to(dtype), torch.from_numpy(scale),
                         torch.from_numpy(bias), 1e-5, gelu).float().numpy()
    got = buf[y_off:y_off + size].reshape(shape)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2)
        _, e = np.frexp(want)
        assert np.mean(np.abs(got - want) > np.ldexp(1.0, e - 8)) <= 1e-3
    if not in_place:  # x is left as it was
        np.testing.assert_array_equal(buf[offset:offset + size], x.reshape(-1))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset1"])
@pytest.mark.parametrize("length", FRONTEND_LENGTHS)
def test_frontend_index_maps(dtype, offset, length):
    """The seven frontend shapes at the explain's batch (24 x 512 rows), the
    card's grid: every tile is walked once; all rows of a channel group share
    one shift; every ring slot a tile reads holds that tile's chunk (copied by
    it or, for its first chunk, by the tile before it in the run, and not
    overwritten since); and every frame of every row is stored exactly once,
    by the tile that owns it or by the next tile of its run. The maps depend
    on a row's start only modulo VEC, beside the tensor's first and last row,
    so one row of each residue class and those two stand for all rows."""
    b, c, item = 24, 512, ITEMSIZE[dtype]
    v, new, r_, F = vec(item), fresh(item), ring(item), frames(item)
    mis = misalignment(offset, item)
    ntl = math.ceil(length / F)
    ntiles = b * ntl
    grid, blocks = walk(ntiles, ntl, item, blocks_per_sm(c, item))
    assert grid <= blocks_per_sm(c, item) * SMS
    assert sorted(s[0] for steps in blocks for s in steps) == list(range(ntiles))

    rows = np.arange(b * c)
    res = (mis + rows * length) % v
    groups = res.reshape(b, c // GROUPS, GROUPS)
    assert (groups == groups[:, :1]).all()
    reps = np.unique(np.concatenate([np.unique(res, return_index=True)[1], [0, b * c - 1]]))

    stores = {int(r): [] for r in reps}
    for steps in blocks:
        slot = {}  # ring slot -> the chunk it holds: its first frame, counted along the batch rows

        def issue(t, q, j0):
            for j in range(j0, new + 1):
                slot[(q + j) % r_] = t * F + v * j

        issue(steps[0][0], steps[0][1], 0)
        for t, q, prev, cont, tn in steps:
            if tn < ntiles:
                issue(tn, (q + new + (0 if cont else 1)) % r_, 1 if cont else 0)
            for j in range(new + 1):
                assert slot[(q + j) % r_] == t * F + v * j
            bi, l0 = t // ntl, t % ntl * F
            sel = reps[reps // c == bi]
            if len(sel):
                start, f, stored, _ = store_mask(sel, l0, min(F, length - l0), prev, cont, mis,
                                                 length, item)
                for k, r in enumerate(sel):
                    frames_k = l0 + f[k][stored[k]]
                    addr = (start[k][:, None] + np.arange(v))[stored[k]]
                    assert (addr == mis + r * length + frames_k).all()
                    stores[int(r)].append(frames_k)
    for parts in stores.values():
        np.testing.assert_array_equal(np.sort(np.concatenate(parts)), np.arange(length))


def test_ring_and_occupancy_arithmetic():
    """At C = 512 a block holds 512 rings of 18 chunks (the tile's 9, the
    next tile's 8 and a spare for a run's first chunk): 148 KB with the scale
    and bias pairs, one block of 16 warps (bf16) or 8 (f32) a SM."""
    assert (fresh(2), ring(2), fresh(4), ring(4)) == (8, 18, 8, 18)
    assert smem_bytes(512, 2) == smem_bytes(512, 4) == 151552 <= 227 * 1024
    assert blocks_per_sm(512, 2) == blocks_per_sm(512, 4) == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("offset", range(8))
def test_out_of_place_output_shares_the_input_residue(dtype, offset):
    """The wrapper's fresh output for `_LnGelu` has x's address modulo 16
    bytes, which the kernel needs (it reads and writes each row at one
    shift), also when x is a view with a storage offset."""
    x = torch.zeros(2 * 8 * 9 + offset, dtype=dtype)[offset:].view(2, 8, 9)
    y = _empty_at_residue(x)
    assert y.shape == x.shape and y.is_contiguous() and y.dtype == x.dtype
    assert y.data_ptr() % 16 == x.data_ptr() % 16
