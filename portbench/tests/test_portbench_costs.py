"""Operations and bytes from shapes, against hand-worked tiny cases."""

from __future__ import annotations

import math

import pytest

from portbench.costs import kernels, model, peaks


def test_bound_takes_the_larger_side():
    t, by = peaks.bound_s(3.35e12, {"bfloat16": 989e12 / 2})
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = peaks.bound_s(0.0, {"float32": 67e12, "int8": 1979e12})
    assert by == "operations" and t == pytest.approx(2.0)


def test_attention_pads_the_head_and_counts_two_products():
    nbytes, ops = kernels.attention(2, 3, 4, 120, "bfloat16")
    assert nbytes == 4 * 2 * 3 * 4 * 128 * 2  # q, k, v read, ctx written, padded to 128
    assert ops == {"bfloat16": 4 * 2 * 4 * 3 * 3 * 128}


def test_stft_and_istft():
    # 8 samples, n_fft 4, hop 2: 1 + 8 // 2 = 5 frames of 3 bins
    nbytes, ops = kernels.stft(1, 8, 4, 2)
    assert nbytes == 4 * (8 + 2 * 3 * 5)
    assert ops["float32"] == 5 * (2.5 * 4 * 2 + 4)
    nbytes_i, ops_i = kernels.istft(1, 8, 4, 2)
    assert nbytes_i == nbytes and ops_i["float32"] == ops["float32"] + 16


def test_roofline_names_keep_b_and_c_apart():
    assert kernels.KERNEL_NAMES["stft"].search("void stft_fft_kernel<1>(float*)")
    assert not kernels.KERNEL_NAMES["stft"].search("istft_fft_kernel(float const*)")
    assert kernels.KERNEL_NAMES["istft"].search("istft_fft_kernel(float const*)")
    assert kernels.KERNEL_NAMES["attention"].search("attention_bf16_kernel(__nv_bfloat16*)")


def test_embedder_ops_tiny():
    e = dict(dtype="bfloat16", quant="none", conv_dim=[2, 2], conv_kernel=[2, 2],
             conv_stride=[2, 1], hidden_size=4, intermediate_size=8,
             num_conv_pos_embedding_groups=2, num_conv_pos_embeddings=3, num_layers=1,
             output_layer=1)
    # 10 samples -> (10-2)//2+1 = 5 -> (5-2)//1+1 = 4 frames
    conv = 2 * 1 * 2 * 2 * 5 + 2 * 2 * 2 * 2 * 4
    proj = 2 * 4 * 2 * 4
    pos = 2 * 4 * 4 * 2 * 3
    layer = 8 * 4 * 4 * 4 + 4 * 4 * 4 * 8 + 4 * 4 * 4 * 4
    assert model.embedder_ops(e, 10) == {"bfloat16": conv + proj + pos + layer}
    q = model.embedder_ops(dict(e, quant="int8"), 10)
    assert q["int8"] == pos + 8 * 4 * 4 * 4 + 4 * 4 * 4 * 8
    assert q["bfloat16"] == conv + proj + 4 * 4 * 4 * 4


def test_unet_ops_by_hand_at_base_one():
    u = dict(base_channels=1, dtype="float32", freq_bins=16, frames=8)
    c, total = 1, 0
    h, w = 16, 8
    # e1, e2: (5, 3) kernels, stride (2, 1); e3, e4: 3x3 stride 2
    sizes = []
    for cin, cout, (kh, kw), (sh, sw) in ((1, 1, (5, 3), (2, 1)), (1, 2, (5, 3), (2, 1)),
                                           (2, 4, (3, 3), (2, 2)), (4, 8, (3, 3), (2, 2))):
        h, w = (h - 1) // sh + 1, (w - 1) // sw + 1
        total += 2 * h * w * cout * cin * kh * kw + 2 * h * w * cout * cout * 9
        sizes.append((h, w, cout))
    total += 2 * h * w * 16 * 8 * 9 + 2 * h * w * 16 * 16 * 9
    for (cin, cout, (kh, kw)), skip in zip(((16, 8, (2, 2)), (8, 4, (2, 2)), (4, 2, (2, 1)),
                                            (2, 1, (2, 1))), (4, 2, 1, 1)):
        total += 2 * h * w * cin * cout * kh * kw
        h, w = h * kh, w * kw
        total += 2 * h * w * cout * (cout + skip) * 9 + 2 * h * w * cout * cout * 9
    total += 2 * h * w * c
    assert (h, w) == (16, 8) and sizes[-1] == (1, 2, 8)
    assert model.unet_ops(u) == {"float32": total}


def test_least_seconds():
    assert model.least_seconds({"bfloat16": 989e12, "float32": 67e12}) == pytest.approx(2.0)
    assert math.isclose(model.least_seconds({}), 0.0)
