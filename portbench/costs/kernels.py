"""Bytes and operations of the port's hand-written kernels A (attention),
B (STFT) and C (iSTFT) at given shapes, and the names their launches carry
in a device trace.

Each input byte is counted read once and each output byte written once.
Attention moves q, k, v and the context in the head-padded layout it takes
([B, T, NH * HDP], HDP the head dim rounded up to 128) and needs 4 B NH T^2
HDP operations (q k^T and p v). A windowed frame costs half a complex
radix-2 FFT's 5 N log2 N plus the window product; the inverse adds an
overlap-add and an envelope division per output sample.
"""

from __future__ import annotations

import math
import re

from portbench.costs.peaks import bound_s

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}

# kernel -> pattern of its launches' names in a trace (B must not match C)
KERNEL_NAMES = {
    "attention": re.compile(r"attention_(bf16|f32)_kernel"),
    "stft": re.compile(r"(?<!i)stft_(fft|dft)_kernel"),
    "istft": re.compile(r"istft_(fft|dft)_kernel"),
}


def head_pad(hd: int) -> int:
    return ((hd + 127) // 128) * 128


def attention(b: int, t: int, nh: int, hd: int, dtype: str) -> tuple[float, dict]:
    """-> (bytes, {dtype: operations}) of one launch of kernel A."""
    hdp = head_pad(hd)
    nbytes = 4 * b * t * nh * hdp * DTYPE_BYTES[dtype]
    return nbytes, {dtype: 4.0 * b * nh * t * t * hdp}


def fft_frame_ops(n_fft: int) -> float:
    return 2.5 * n_fft * math.log2(n_fft) + n_fft


def num_frames(n_samples: int, hop: int) -> int:
    return 1 + n_samples // hop


def stft(b: int, n_samples: int, n_fft: int, hop: int) -> tuple[float, dict]:
    """-> (bytes, ops) of kernel B on [b, n_samples] f32 (centred frames)."""
    t = num_frames(n_samples, hop)
    bins = n_fft // 2 + 1
    return 4.0 * (b * n_samples + 2 * b * bins * t), {"float32": b * t * fft_frame_ops(n_fft)}


def istft(b: int, n_samples: int, n_fft: int, hop: int) -> tuple[float, dict]:
    """-> (bytes, ops) of kernel C to [b, n_samples] f32."""
    t = num_frames(n_samples, hop)
    bins = n_fft // 2 + 1
    ops = b * t * fft_frame_ops(n_fft) + 2.0 * b * n_samples
    return 4.0 * (b * n_samples + 2 * b * bins * t), {"float32": ops}


def explain_kernel_bounds(cfg: dict, batch: int) -> dict:
    """{kernel: least seconds of its launches in one explain of `batch`
    clips with the UNet}: A over the embedder's layers at 3 x batch, B once,
    C twice."""
    e, sc = cfg["embedder"], cfg["stft"]
    n = int(cfg["audio"]["clip_seconds"] * cfg["audio"]["sample_rate"])
    frames = embedder_frames(e, n)
    layers = min(e["num_layers"], e["output_layer"])
    a = bound_s(*attention(3 * batch, frames, e["num_heads"], e["hidden_size"] // e["num_heads"],
                           e["dtype"]))[0]
    b = bound_s(*stft(batch, n, sc["n_fft"], sc["hop_length"]))[0]
    c = bound_s(*istft(batch, n, sc["n_fft"], sc["hop_length"]))[0]
    return {"attention": layers * a, "stft": b, "istft": 2 * c}


def embedder_frames(e: dict, n_samples: int) -> int:
    length = n_samples
    for k, s in zip(e["conv_kernel"], e["conv_stride"]):
        length = (length - k) // s + 1
    return length


def roofline_percent(trace, cfg: dict, batch: int, kernel: str):
    """The share, in %, of its roofline that `kernel` reached over a traced
    stretch of explains: its least time for the stretch's work over the
    device time of its launches; None where it did not run."""
    if trace is None:
        return None
    device_s, launches = trace.kernel_seconds(KERNEL_NAMES[kernel])
    if launches == 0 or device_s <= 0:
        return None
    return 100.0 * trace.units * explain_kernel_bounds(cfg, batch)[kernel] / device_s
