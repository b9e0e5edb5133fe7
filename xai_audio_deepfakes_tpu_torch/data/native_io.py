"""ctypes bridge to the repository's native C++ audio library (port of
`data/native_io.py`): 16-bit PCM WAV decode and encode in
`native/libaudio_io.so`, used as it is committed (the port builds nothing
there).

Where the library is missing or does not load, `available()` is False and
`data/io.py` decodes and encodes in Python (scipy, then `wave`), bit for bit
the same.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

LIBRARY = Path(__file__).resolve().parents[2] / "native" / "libaudio_io.so"


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL | None:
    if not LIBRARY.exists():
        return None
    try:
        lib = ctypes.CDLL(str(LIBRARY))
    except OSError:  # built for another machine
        return None
    lib.decode_wav_pcm16.restype = ctypes.c_int64
    lib.decode_wav_pcm16.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    if hasattr(lib, "encode_wav_pcm16"):  # a library built before the writer has none
        lib.encode_wav_pcm16.restype = ctypes.c_int64
        lib.encode_wav_pcm16.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int32,
        ]
    return lib


def available() -> bool:
    return _load() is not None


def read_wav_native(path: str, max_samples: int = 16000 * 60 * 10):
    """-> (float32 mono [L] or [C, L] waveform, sample rate), or None where
    the library is unavailable or the encoding is not 16-bit PCM."""
    lib = _load()
    if lib is None:
        return None
    buf = np.empty(max_samples, dtype=np.float32)
    sr = ctypes.c_int32(0)
    ch = ctypes.c_int32(0)
    n = lib.decode_wav_pcm16(
        path.encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_samples,
        ctypes.byref(sr),
        ctypes.byref(ch),
    )
    if n <= 0:
        return None  # unsupported encoding: the Python decoder takes it
    out = buf[:n].copy()
    if ch.value > 1:
        out = out.reshape(-1, ch.value).T
    return out, int(sr.value)


def write_wav_native(path: str, wav: np.ndarray, sample_rate: int) -> bool:
    """float32 in [-1, 1] (mono [L] or [C, L]) -> 16-bit PCM WAV by the C++
    encoder, the same bytes as the scipy path (clip, then truncate). False
    where the library or its encoder is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "encode_wav_pcm16"):
        return False
    wav = np.asarray(wav, dtype=np.float32)
    if wav.ndim == 2:  # [C, L] -> interleaved frames
        channels = wav.shape[0]
        wav = np.ascontiguousarray(wav.T).reshape(-1)
    else:
        channels = 1
        wav = np.ascontiguousarray(wav.reshape(-1))
    rc = lib.encode_wav_pcm16(
        path.encode(),
        wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        wav.size,
        int(sample_rate),
        channels,
    )
    return rc == 0
