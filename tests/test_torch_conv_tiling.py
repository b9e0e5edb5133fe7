"""PyTorch port, kernel E's bf16 plan on the CPU: a numpy emulation of
`csrc/conv_ln_gelu.cu::conv_ln_gelu_bf16_kernel` against the kernel's plain
version `conv_ln_gelu_plain`.

The emulation follows the kernel's index maps thread by thread: the
producer warpgroup's raw sample rows (16-byte pieces from the boundary at or
below each row's first sample, zero past the end of x) and the im2col
planes it builds from them, even and odd samples, X_tap[t, ci] =
x[ci, 2 (t0 + t) + tap] being plane tap % 2 from frame tap // 2 on; both
wgmma operands read through K-major descriptors, the planes (rows 16 bytes
apart, the two 8-channel halves a plane-half apart) and the weight stage
(the wrapper's own `weight_image`: core matrices of 8 rows x 16 bytes, 128
bytes between the two halves, 256 between groups of 8 rows); wgmma's
accumulator layout; and the epilogue's cast points (sum rounded to bf16,
conv bias in f32, mean and centred variance over the channels, normalised
value rounded, GELU in f32). The kernel itself runs only on the card
(`tests/test_torch_kernels.py`). This file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from xai_audio_deepfakes_tpu_torch.ops.cuda_conv import (
    CHUNK,
    conv_ln_gelu_plain,
    supports_fused_conv,
    weight_image,
)

TFW = 64  # frames per block
RAW_LD = 144  # elements of a raw row
LANES = np.arange(32)


PLANE_HALF = (TFW + 8) * 8  # elements of one 8-channel half of a plane


def _x_stage(flat, l, row0, c, t0, k):
    """The producer warpgroup's two planes, flat: [even / odd][2 halves][72
    frames][8 channels], plane p row t holding x[ci, 2 (t0 + t) + p], for
    chunk c: the raw rows as cp.async copies them, then thread (pw, r, pp)'s
    frames 8 tb + r and input channel pairs 8 h + 2 pp, + 1."""
    total = flat.size
    first = (row0 + c * CHUNK) * l + 2 * t0
    raw = np.zeros((CHUNK, RAW_LD + 8))
    for ci in range(CHUNK):
        for j in range(RAW_LD // 8):
            start = (first + ci * l) // 8 * 8 + 8 * j
            n = min(8, max(0, total - start))
            raw[ci, 8 * j:8 * j + n] = flat[start:start + n]
    planes = np.zeros(2 * 2 * PLANE_HALF)
    for pt in range(128):
        pw, r, pp = pt // 32, (pt % 32) >> 2, pt & 3
        for h in range(2):
            ci = 8 * h + 2 * pp
            shift = [(first + (ci + i) * l) % 8 for i in range(2)]
            for item in range(5):
                plane = 0 if item < 2 or item == 4 else 1
                tb = 8 if item == 4 else 2 * pw + (item & 1)
                if item == 4 and (k != 3 or pw != 3):
                    continue
                t = 8 * tb + r
                inside = t <= TFW and 2 * (t0 + t) + plane < l
                base = plane * 2 * PLANE_HALF + h * PLANE_HALF + t * 8 + 2 * pp
                for i in range(2):
                    planes[base + i] = raw[ci + i, shift[i] + 2 * t + plane] if inside else 0.0
    return planes


def _k_major(smem, start, rows, lbo=128, sbo=256):
    """A wgmma operand (rows x 16) from a K-major descriptor without swizzle
    (byte offsets): element [m, k] at start + (m // 8) sbo + (k // 8) lbo +
    (m % 8) 16 + (k % 8) 2."""
    m, k = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    byte = start + (m // 8) * sbo + (k // 8) * lbo + (m % 8) * 16 + (k % 8) * 2
    return smem[byte // 2]


def _block_acc(x, img, bi, t0, k):
    """The two consumer warpgroups' f32 sums of one block, as acc[wg, warp,
    lane, NW / 2] in wgmma's accumulator layout."""
    cin, l = x.shape[1], x.shape[2]
    cout = img.shape[2] * 8
    nw = cout // 2
    flat = x.reshape(-1)
    g, q = LANES // 4, LANES % 4
    acc = np.zeros((2, 4, 32, nw // 2))
    for c in range(cin // CHUNK):
        ws, xs = img[c].reshape(-1), _x_stage(flat, l, bi * cin, c, t0, k)
        for tap in range(k):
            # tap 2 is the even plane one frame on
            a = _k_major(xs, (tap & 1) * 4 * PLANE_HALF + (tap >> 1) * 16, TFW, 2 * PLANE_HALF, 128)
            for wg in range(2):
                d = a @ _k_major(ws, (tap * cout + wg * nw) * CHUNK * 2, nw).T  # [64, NW]
                for w4 in range(4):
                    for jj in range(nw // 8):
                        for r in range(2):
                            for e in range(2):
                                acc[wg, w4, :, 4 * jj + 2 * r + e] += d[16 * w4 + g + 8 * r, 8 * jj + 2 * q + e]
    return acc


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def emulated_conv_ln_gelu(x, w, cb, scale, bias, eps):
    """Kernel E's bf16 plan on bf16-valued f32 arrays, exact GELU."""
    b, _, l = x.shape
    cout, _, k = w.shape
    nw = cout // 2
    lout = (l - k) // 2 + 1
    img = weight_image(torch.from_numpy(w)).numpy()
    g, q = LANES // 4, LANES % 4
    y = np.zeros((b, cout, lout), np.float32)
    for bi in range(b):
        for t0 in range(0, lout, TFW):
            acc = _block_acc(x, img, bi, t0, k)
            tile = np.zeros((cout, TFW), np.float32)  # the accumulators at their (co, t)
            for wg in range(2):
                for w4 in range(4):
                    for jj in range(nw // 8):
                        for r in range(2):
                            for e in range(2):
                                tile[wg * nw + 8 * jj + 2 * q + e, 16 * w4 + g + 8 * r] = \
                                    acc[wg, w4, :, 4 * jj + 2 * r + e]
            a = (_bf16(tile) + cb[:, None]).astype(np.float32)
            mu = a.sum(0) / np.float32(cout)
            rs = 1.0 / np.sqrt(((a - mu) ** 2).sum(0) / np.float32(cout) + np.float32(eps))
            normed = _bf16((a - mu) * rs * scale[:, None] + bias[:, None])
            out = torch.nn.functional.gelu(torch.from_numpy(normed)).bfloat16().float().numpy()
            nt = min(TFW, lout - t0)
            y[bi, :, t0:t0 + nt] = out[:, :nt]
    return y


@pytest.mark.parametrize("k,length", [(3, 141), (2, 140)], ids=["k3", "k2"])
def test_bf16_plan_matches_plain(rng, k, length):
    """Cin = Cout = 128, two clips, 70 output frames (a full 64-frame tile
    and a ragged one of 6; the last clip's raw rows run past the end of x).
    The bar is the kernel's on the card: four bf16 steps (1e-2 + 3.2e-2
    |y|), at most 0.1% of the elements more than one step off, since the f32
    sums are taken in another order than the plain version's and a sum may
    round to the neighbouring bf16 value."""
    c = 128
    x = _bf16(rng.standard_normal((2, c, length)))
    w = _bf16(rng.standard_normal((c, c, k)) * (c * k) ** -0.5)
    cb = _bf16(rng.standard_normal(c) * 0.1)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    got = emulated_conv_ln_gelu(x, w, cb, scale, bias, 1e-5)
    want = conv_ln_gelu_plain(*(torch.from_numpy(a).bfloat16() for a in (x, w, cb)),
                              torch.from_numpy(scale), torch.from_numpy(bias), 1e-5,
                              "exact").float().numpy()
    assert got.shape == want.shape == (2, c, 70)
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=3.2e-2)
    assert np.mean(np.abs(got - want) > 1e-2 + 1e-2 * np.abs(want)) <= 1e-3


def test_plane_stores_hit_distinct_banks():
    """A producer warp's 32 threads store 8 frames x 8 channels (128 bytes)
    of a plane per step, each its own 4-byte word: no bank conflict."""
    for pw in range(4):
        lanes = np.arange(32 * pw, 32 * pw + 32)
        r, pp = (lanes % 32) >> 2, lanes & 3
        for plane in range(2):
            for h in range(2):
                for tb in (2 * pw, 2 * pw + 1, 8):
                    t = 8 * tb + r
                    words = (plane * 2 * PLANE_HALF + h * PLANE_HALF + t * 8 + 2 * pp) // 2
                    assert len(set(words % 32)) == 32


def test_weight_image_index_map(rng):
    """Element [c, tap, cb, h, r, j] of the image is weight[8 cb + r,
    16 c + 8 h + j, tap]."""
    w = torch.from_numpy(rng.standard_normal((128, 32, 3)).astype(np.float32))
    img = weight_image(w)
    assert img.shape == (2, 3, 16, 2, 8, 8) and img.is_contiguous()
    c, tap, cb, h, r, j = np.meshgrid(*(np.arange(n) for n in img.shape), indexing="ij")
    np.testing.assert_array_equal(img.numpy(), w.numpy()[8 * cb + r, 16 * c + 8 * h + j, tap])


@pytest.mark.parametrize("cout,fused", [(128, True), (256, True), (512, True), (384, False),
                                        (640, False), (1024, False)])
def test_fused_conv_only_for_instantiated_couts(cout, fused):
    """The bf16 body is built for Cout 128, 256 and 512 alone; any other Cout
    takes conv + kernel D, so the wrapper never meets a Cout it cannot launch."""
    assert supports_fused_conv(3, 2, 512, cout) is fused
