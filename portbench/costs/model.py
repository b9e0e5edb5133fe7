"""Operations of an explain from its shapes, by the type they run in.

Counted: every product of a convolution or a projection (2 operations a
multiply-add, a grouped convolution over its group's channels, a transposed
convolution over its input positions), attention's two products at the
unpadded head width, and the transforms as `kernels.fft_frame_ops` counts
them. Not counted: LayerNorms, GELUs, BatchNorms, the softmax, the masking,
casts and the int8 quantize passes, which run at no peak the card publishes.
"""

from __future__ import annotations

from portbench.costs import kernels
from portbench.costs.peaks import PEAK_OPS_PER_S
from portbench.reference.unet import DECODER, ENCODER


def _add(acc: dict, dtype: str, ops: float) -> None:
    acc[dtype] = acc.get(dtype, 0.0) + ops


def embedder_ops(e: dict, n_samples: int) -> dict:
    """{dtype: operations} of one clip through the embedder."""
    acc: dict = {}
    dt = e["dtype"]
    length, cin = n_samples, 1
    for cout, k, s in zip(e["conv_dim"], e["conv_kernel"], e["conv_stride"]):
        length = (length - k) // s + 1
        _add(acc, dt, 2.0 * cin * k * cout * length)
        cin = cout
    t, h, inter = length, e["hidden_size"], e["intermediate_size"]
    prod = "int8" if e.get("quant", "none") != "none" else dt
    _add(acc, dt, 2.0 * t * cin * h)  # feature projection
    g, kpos = e["num_conv_pos_embedding_groups"], e["num_conv_pos_embeddings"]
    _add(acc, prod, 2.0 * t * h * (h // g) * kpos)
    layers = min(e["num_layers"], e["output_layer"])
    _add(acc, prod, layers * (8.0 * t * h * h + 4.0 * t * h * inter))
    _add(acc, dt, layers * 4.0 * t * t * h)
    return acc


def _conv_out(n: int, k: int, s: int, p: int, d: int = 1) -> int:
    return (n + 2 * p - d * (k - 1) - 1) // s + 1


def unet_ops(u: dict) -> dict:
    """{dtype: operations} of one clip's (freq_bins, frames) magnitude
    through the UNet."""
    c, dt = u["base_channels"], u["dtype"]
    acc: dict = {}
    hw = [(u["freq_bins"], u["frames"])]
    ch = [1]
    for _, ci, co, k, s, p in ENCODER:
        h, w = hw[-1]
        h, w = _conv_out(h, k[0], s[0], p[0]), _conv_out(w, k[1], s[1], p[1])
        cin = max(ci * c, 1)
        _add(acc, dt, 2.0 * h * w * co * c * cin * k[0] * k[1])
        _add(acc, dt, 2.0 * h * w * co * c * co * c * 9)
        hw.append((h, w))
        ch.append(co * c)
    h, w = hw[-1]
    _add(acc, dt, 2.0 * h * w * 16 * c * 8 * c * 9)
    _add(acc, dt, 2.0 * h * w * 16 * c * 16 * c * 9)
    for (_, _, ci, co, k, _), (hs, ws), cs in zip(DECODER, reversed(hw[:-1]), reversed(ch[:-1])):
        _add(acc, dt, 2.0 * h * w * ci * c * co * c * k[0] * k[1])
        h, w = h * k[0], w * k[1]
        if (h, w) != (hs, ws):
            raise ValueError(f"the transposed conv gives {(h, w)}, its skip is {(hs, ws)}")
        _add(acc, dt, 2.0 * h * w * co * c * (co * c + cs) * 9)
        _add(acc, dt, 2.0 * h * w * co * c * co * c * 9)
    _add(acc, dt, 2.0 * h * w * c)  # the 1x1 head
    return acc


def explain_ops(cfg: dict, batch: int) -> dict:
    """{dtype: operations} of one explain (UNet decoder) of `batch` clips."""
    n = int(cfg["audio"]["clip_seconds"] * cfg["audio"]["sample_rate"])
    sc = cfg["stft"]
    acc: dict = {}
    for dtype, ops in embedder_ops(cfg["embedder"], n).items():
        _add(acc, dtype, 3 * batch * ops)
    for dtype, ops in unet_ops(cfg["unet"]).items():
        _add(acc, dtype, batch * ops)
    for fn, times in ((kernels.stft, 1), (kernels.istft, 2)):
        _, ops = fn(batch, n, sc["n_fft"], sc["hop_length"])
        _add(acc, "float32", times * ops["float32"])
    return acc


def least_seconds(ops_by_dtype: dict) -> float:
    """The operations' time at the peak rate of each type."""
    return sum(ops / PEAK_OPS_PER_S[dt] for dt, ops in ops_by_dtype.items())


def train_step_ops(cfg: dict, batch: int) -> dict:
    """{dtype: operations} of one LMAC step of `batch` clips: the collate's
    STFT and target embed, the UNet forward and its backward (input and
    weight gradients, twice the forward), the two inverse STFTs and their
    backward, two embedder forwards and their input gradients (the frozen
    weights take none: once the forward)."""
    n = int(cfg["audio"]["clip_seconds"] * cfg["audio"]["sample_rate"])
    sc = cfg["stft"]
    acc: dict = {}
    for dtype, ops in embedder_ops(cfg["embedder"], n).items():
        _add(acc, dtype, (1 + 2 * 2) * batch * ops)
    for dtype, ops in unet_ops(cfg["unet"]).items():
        _add(acc, dtype, 3 * batch * ops)
    for fn, times in ((kernels.stft, 1), (kernels.istft, 2 * 2)):
        _, ops = fn(batch, n, sc["n_fft"], sc["hop_length"])
        _add(acc, "float32", times * ops["float32"])
    return acc
