"""PyTorch port, kernel F (the grouped positional conv) on the CPU: its plain
version against the embedder's `_conv1d` path, the autograd function's
gradients, the dispatch of `PositionalConvEmbedding`, the weight images, and
a numpy emulation of `csrc/pos_conv.cu`'s index maps.

The emulation follows the kernel block by block: the producer's A tile (one
plane of 8 channels per chunk of the group, rows 16 bytes apart from frame
t0 - pad_left on, zero outside the clip, plane 0 copied behind the last
plane where cg / 8 is odd), the consumers' walk over K (two 8-channel
chunks a k16 step, tap j's rows read j rows on, a step that straddles two
taps reading the copy from the next row), both wgmma operands read through
K-major descriptors from the same byte offsets as the kernel's, the weight
stage from the wrapper's own `pos_conv_image`, and the epilogue's frames.
It sums in float64, so it is held to float64 convolutions to 1e-9: a wrong
offset anywhere is off by a whole product. The kernel itself runs only on
the card (`tests/test_torch_kernels.py`). This file imports nothing of JAX.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from xai_audio_deepfakes_tpu_torch.config import EmbedderConfig
from xai_audio_deepfakes_tpu_torch.models.wav2vec2 import (
    PositionalConvEmbedding,
    _conv1d,
    _gelu,
)
from xai_audio_deepfakes_tpu_torch.ops import _cuda
from xai_audio_deepfakes_tpu_torch.ops.cuda_pos_conv import (
    STAGE_STEPS,
    WIDTH,
    grad_weight,
    image_steps,
    pos_conv,
    pos_conv_grad_image,
    pos_conv_image,
    pos_conv_plain,
    supports_pos_conv,
    weight_from_image,
)

TM = 256  # output frames per block
PAD_ROWS = 2 * STAGE_STEPS + 1  # tile rows past tap k - 1


def _module(dtype="bfloat16", quant="none", hidden=32, groups=2, k=16, seed=0):
    cfg = dataclasses.replace(EmbedderConfig.tiny(), dtype=dtype, quant=quant, hidden_size=hidden,
                              num_conv_pos_embedding_groups=groups, num_conv_pos_embeddings=k)
    m = PositionalConvEmbedding(cfg, torch.Generator().manual_seed(seed), "cpu")
    with torch.no_grad():
        m.conv.bias.normal_(generator=torch.Generator().manual_seed(seed + 1))
    return m


def _existing_path(x, conv):
    """`_conv1d` on [B, H, T] with the trailing frame of an even k dropped,
    as [B, T, H]."""
    y = _conv1d(x.transpose(1, 2), conv)
    return y[..., :x.shape[1]].transpose(1, 2)


# ---------------------------------------------------------------------------
# the plain version and the gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 7, 33])
@pytest.mark.parametrize("k", [16, 5])
def test_plain_matches_conv1d_at_the_forward_cast_points(dtype, t, k):
    """pos_conv_plain(x, w, b, k // 2, T) on [B, T, H] is `_conv1d` on the
    transposed x with the trailing frame of an even k dropped: the f32 sum
    rounded to the dtype, the bias added in the dtype."""
    m = _module(dtype=dtype, k=k)
    x = torch.randn(2, t, 32, generator=torch.Generator().manual_seed(t)).to(m.conv.weight.dtype)
    got = pos_conv_plain(x, m.conv.weight, m.conv.bias, k // 2, t)
    want = _existing_path(x, m.conv)
    assert got.shape == (2, t, 32) and got.dtype == x.dtype and got.is_contiguous()
    atol = 1e-5 if dtype == "float32" else 0.0  # f32: another summation order
    torch.testing.assert_close(got, want, atol=atol, rtol=atol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2 ** -7)])
@pytest.mark.parametrize("t", [1, 7, 33])
def test_input_gradient_is_the_flipped_conv(dtype, tol, t):
    """The autograd function's input gradient (`addv::pos_conv_dgrad` on the
    gradient image, pad_left k - 1 - k // 2 = 7 at k 16) against autograd
    through `_conv1d`; and the op's result is the plain version of the
    flipped, transposed conv."""
    m = _module(dtype=dtype)
    g = torch.Generator().manual_seed(10 + t)
    x0 = torch.randn(2, t, 32, generator=g).to(m.conv.weight.dtype)
    gy = torch.randn(2, t, 32, generator=g).to(x0.dtype)
    x_ref, x_new = x0.clone().requires_grad_(), x0.clone().requires_grad_()
    _existing_path(x_ref, m.conv).backward(gy)
    y = pos_conv(x_new, m.conv.weight, m.conv.bias, m.k // 2,
                 grad_image=pos_conv_grad_image(m.conv.weight))
    y.backward(gy)
    assert x_new.grad.dtype == x0.dtype
    torch.testing.assert_close(x_new.grad.float(), x_ref.grad.float(), atol=tol, rtol=tol)
    flipped = pos_conv_plain(gy, grad_weight(m.conv.weight), None, m.k - 1 - m.k // 2, t)
    torch.testing.assert_close(x_new.grad, flipped, atol=0, rtol=0)


def test_weight_and_bias_gradients_where_asked_for():
    """Where the weight and the bias require a gradient (no use of the
    system asks: the embedder is frozen), they get autograd's through the
    f32 conv."""
    m = _module(dtype="float32", k=5)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 9, 32, generator=g)
    gy = torch.randn(2, 9, 32, generator=g)
    w = m.conv.weight.detach().clone().requires_grad_()
    b = m.conv.bias.detach().clone().requires_grad_()
    pos_conv(x, w, b, 2).backward(gy)
    w_ref = m.conv.weight.detach().clone().requires_grad_()
    b_ref = m.conv.bias.detach().clone().requires_grad_()
    ref = F.conv1d(x.transpose(1, 2), w_ref, b_ref, padding=2, groups=2).transpose(1, 2)
    ref.backward(gy)
    torch.testing.assert_close(w.grad, w_ref.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(b.grad, b_ref.grad, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_dispatch_predicate():
    """bf16 on a card takes kernel F; f32, the CPU and int8 keep their
    paths; a group width that is no multiple of 8 or wider than 120, or more
    than 128 taps, too."""
    bf16 = _module()
    assert bf16.takes_kernel("cuda", torch.bfloat16)
    assert not bf16.takes_kernel("cpu", torch.bfloat16)
    assert not bf16.takes_kernel("cuda", torch.float32)
    assert not _module(dtype="float32").takes_kernel("cuda", torch.float32)
    assert not _module(quant="int8").takes_kernel("cuda", torch.bfloat16)
    # the trainer's int8 target view (`with_config`) keeps the bf16 weights
    view = copy.copy(bf16)
    view.quant = True
    assert not view.takes_kernel("cuda", torch.bfloat16)
    assert not _module(hidden=24, groups=2).takes_kernel("cuda", torch.bfloat16)  # cg 12
    assert not _module(hidden=256, groups=2).takes_kernel("cuda", torch.bfloat16)  # cg 128
    assert _module(hidden=240, groups=2).takes_kernel("cuda", torch.bfloat16)  # cg 120
    assert not _module(k=130).takes_kernel("cuda", torch.bfloat16)
    assert [supports_pos_conv(128, cg) for cg in (8, 64, 72, 120, 128, 12)] == [
        True, True, True, True, False, False]


def test_cpu_module_keeps_conv1d_and_launches_nothing():
    """On the CPU the module's float path is `_conv1d` as before, bit for
    bit, and no kernel op is counted."""
    m = _module()
    x = torch.randn(2, 11, 32, generator=torch.Generator().manual_seed(5)).bfloat16()
    _cuda.reset_launches()
    got = m(x)
    assert _cuda.LAUNCHES["pos_conv"] == 0 and _cuda.LAUNCHES["pos_conv_dgrad"] == 0
    y = _conv1d(x.transpose(1, 2), m.conv)[..., :-1]
    want = _gelu(y, m.cfg.gelu).transpose(1, 2)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the weight images
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cg,k", [(120, 128), (24, 5), (8, 3), (64, 16), (16, 1)])
def test_image_layout_padding_and_round_trip(cg, k):
    """Element [g, s, nb, h, r, j] is w[g cg + 8 nb + r, kk % cg, kk // cg],
    kk = 16 s + 8 h + j; output channels past cg and K past k cg are exact
    zeros; the image holds the weight bit for bit."""
    groups = 2
    w = torch.randn(groups * cg, cg, k, generator=torch.Generator().manual_seed(cg)).bfloat16()
    img = pos_conv_image(w)
    n, steps = WIDTH, image_steps(k, cg)
    assert img.shape == (groups, steps, n // 8, 2, 8, 8) and steps % STAGE_STEPS == 0
    assert steps * 16 >= k * cg > (steps - STAGE_STEPS) * 16
    a = img.float().numpy()
    wn = w.float().numpy()
    rng = np.random.default_rng(0)
    for _ in range(200):
        g, s, nb, h, r, j = (int(rng.integers(d)) for d in a.shape)
        co, kk = 8 * nb + r, 16 * s + 8 * h + j
        want = wn[g * cg + co, kk % cg, kk // cg] if co < cg and kk < k * cg else 0.0
        assert a[g, s, nb, h, r, j] == want
    wk = img.permute(0, 2, 4, 1, 3, 5).reshape(groups, n, steps * 16)
    assert not wk[:, cg:].any() and not wk[:, :, k * cg:].any()
    assert torch.equal(weight_from_image(img, groups * cg, k), w)


def test_gradient_image_flips_taps_and_swaps_channels():
    """grad_weight(w)[g cg + ci, co, tap] = w[g cg + co, ci, k - 1 - tap],
    and the gradient image is the image of that weight."""
    cg, k, groups = 24, 7, 3
    w = torch.randn(groups * cg, cg, k, generator=torch.Generator().manual_seed(1)).bfloat16()
    gw = grad_weight(w)
    for g, ci, co, tap in [(0, 0, 0, 0), (1, 5, 17, 2), (2, 23, 3, 6), (2, 0, 23, 3)]:
        assert gw[g * cg + ci, co, tap] == w[g * cg + co, ci, k - 1 - tap]
    assert torch.equal(pos_conv_grad_image(w), pos_conv_image(gw))


# ---------------------------------------------------------------------------
# numpy emulation of the kernel's index maps
# ---------------------------------------------------------------------------


def _k_major(flat, start, rows, lbo, sbo):
    """A wgmma operand (rows x 16) from a K-major descriptor without swizzle
    over a flat array of 2-byte elements (byte offsets): element [m, k] at
    start + (m // 8) sbo + (k // 8) lbo + (m % 8) 16 + (k % 8) 2."""
    m, kk = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    byte = start + (m // 8) * sbo + (kk // 8) * lbo + (m % 8) * 16 + (kk % 8) * 2
    return flat[byte // 2]


def _emulate(x, image, k, pad_left, t_out):
    """The kernel's f32 sums (here float64) for x [B, T, H] -> [B, t_out, H]."""
    xb = x.double().numpy()
    bsz, t_in, h = xb.shape
    groups, steps, nb = image.shape[:3]
    n, cg = 8 * nb, h // groups
    nch = cg // 8
    planes = nch + (nch & 1)
    rows = TM + k + PAD_ROWS
    stage_elems = STAGE_STEPS * n * 16
    img = image.double().numpy().reshape(groups, -1)
    out = np.zeros((bsz, t_out, h))
    for g in range(groups):
        for b in range(bsz):
            for t0 in range(0, t_out, TM):
                tile = np.zeros(planes * rows * 8)  # [plane][row][8 channels]
                for p in range(planes):
                    c = p if p < nch else 0
                    for r in range(rows):
                        t = t0 - pad_left + r
                        if 0 <= t < t_in:
                            tile[(p * rows + r) * 8:(p * rows + r + 1) * 8] = \
                                xb[b, t, g * cg + 8 * c:g * cg + 8 * c + 8]
                acc = np.zeros((TM, n))
                tap = c = 0
                for st in range(steps // STAGE_STEPS):
                    stage = img[g, st * stage_elems:(st + 1) * stage_elems]
                    for j in range(STAGE_STEPS):
                        lbo = rows * 16 + (16 if c + 1 == nch else 0)
                        a0 = (c * rows + tap) * 16
                        bm = _k_major(stage, j * n * 32, n, 128, 256)  # [N, 16]
                        for wgp in range(2):
                            for i in range(2):
                                m0 = 128 * wgp + 64 * i
                                am = _k_major(tile, a0 + m0 * 16, 64, lbo, 128)  # [64, 16]
                                acc[m0:m0 + 64] += am @ bm.T
                        c += 2
                        while c >= nch:
                            c -= nch
                            tap += 1
                nt = min(TM, t_out - t0)
                out[b, t0:t0 + nt, g * cg:(g + 1) * cg] = acc[:nt, :cg]
    return out


def _conv_f64(x, weight, pad_left, t_out):
    h, cg, k = weight.shape
    xt = x.double().transpose(1, 2)
    xt = F.pad(xt, (pad_left, max(t_out + k - 1 - x.shape[1] - pad_left, 0)))
    y = F.conv1d(xt, weight.double(), groups=h // cg)[..., :t_out]
    return y.transpose(1, 2).numpy()


@pytest.mark.parametrize("cg,groups,k,t", [
    (120, 1, 128, 300),  # XLS-R's group: two frame tiles, the 64-frame pad at both ends
    (8, 2, 128, 300),    # one chunk a tap: every step straddles two taps
    (24, 2, 5, 10),      # odd chunks, odd k: the last step half past K
    (64, 2, 16, 40),     # even chunks: no step straddles; padded stages
])
def test_emulated_index_maps_match_the_conv(cg, groups, k, t):
    """The forward (pad_left k // 2, the trailing frame never computed) and
    the input gradient (the gradient image, pad_left k - 1 - k // 2) through
    the kernel's A tile, K walk, descriptors and weight stages equal float64
    convolutions."""
    g = torch.Generator().manual_seed(cg + k)
    w = (torch.randn(groups * cg, cg, k, generator=g) * 0.1).bfloat16()
    x = torch.randn(1, t, groups * cg, generator=g).bfloat16()
    for weight, image, pad in ((w, pos_conv_image(w), k // 2),
                               (grad_weight(w), pos_conv_grad_image(w), k - 1 - k // 2)):
        got = _emulate(x, image, k, pad, t)
        want = _conv_f64(x, weight, pad, t)
        np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)


# ---------------------------------------------------------------------------
# the benchmark's reader of kernel F's roofline
# ---------------------------------------------------------------------------


class _Trace:
    """What `pos_conv_roofline.offline` reads of a trace: (name, start us,
    end us) device operations and the units of the stretch."""

    def __init__(self, ops, units):
        from portbench.tracing import Trace

        self.ops, self.units = ops, units
        self.kernel_seconds = Trace.kernel_seconds.__get__(self)


def test_roofline_reader_counts_the_forward_launches_only():
    """At the entry cell's shapes the least time of an explain's kernel F is
    2 x 192 x 249 x 1920 x 120 x 128 operations at 989 TFLOP/s (2.851 ms,
    bound by operations); the reader matches the forward kernel's launches
    by name (not the gradient's) and reads nothing where none ran, as on a
    program without kernel F."""
    import json
    from types import SimpleNamespace

    from portbench import harness

    read = harness.load_reader("pos_conv_roofline.offline")
    cfg = json.loads((harness.HERE / "configs" / "xlsr2b-l9-entry.json").read_text())["pipeline"]
    least = read.__globals__["least_seconds"](cfg, 64)
    assert least == pytest.approx(2.0 * 192 * 249 * 1920 * 120 * 128 / 989e12)
    assert least * 1e3 == pytest.approx(2.851, abs=1e-3)
    fwd = "void (anonymous namespace)::pos_conv_fwd_kernel<120>(__nv_bfloat16 const*)"
    dgrad = "void (anonymous namespace)::pos_conv_dgrad_kernel<120>(__nv_bfloat16 const*)"
    ops = [(fwd, 0.0, 5000.0), (dgrad, 6000.0, 9000.0), ("sm90_xmma_gemm", 9000.0, 9500.0),
           (fwd, 10000.0, 15000.0)]  # two explains, 5 ms each
    r = SimpleNamespace(trace=_Trace(ops, 2), cfg=cfg, window={"batch": 64})
    assert read(r) == pytest.approx(100.0 * least / 5e-3)
    assert read(SimpleNamespace(trace=_Trace(ops[1:3], 2), cfg=cfg, window={"batch": 64})) is None
    assert read(SimpleNamespace(trace=None, cfg=cfg, window={"batch": 64})) is None
