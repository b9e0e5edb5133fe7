"""Audio I/O, the host side of the input pipeline (port of `data/io.py`).

`load_audio` keeps the reference's `load_audio` contract: read, mono (the
first channel), resample to 16 kHz where needed, right-zero-pad or crop to
exactly 5 s. Decoding goes native first (`data/native_io.py`), then scipy,
then the standard library's `wave`; the PCM conventions are the JAX
package's (int16 / 32768, int32 / 2^31, (uint8 - 128) / 128; multichannel
[C, L]; written as clip(x, -1, 1) * 32767 truncated to int16).
"""

from __future__ import annotations

import io as _io
import os
import wave

import numpy as np

from xai_audio_deepfakes_tpu_torch.data import native_io
from xai_audio_deepfakes_tpu_torch.ops.resample import resample_poly_np


def _pcm_to_float(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.int16:
        out = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        out = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        out = (data.astype(np.float32) - 128.0) / 128.0
    else:
        out = data.astype(np.float32)
    if out.ndim == 2:
        out = out.T  # [C, L]
    return out


def _decode_with_wave(f) -> tuple[np.ndarray, int]:
    """The standard library's decoder (16- and 8-bit PCM) for a path or a
    file object."""
    with wave.open(f, "rb") as w:
        sr = w.getframerate()
        raw = w.readframes(w.getnframes())
        width = w.getsampwidth()
        ch = w.getnchannels()
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch).T
    return data, sr


def _decode(source) -> tuple[np.ndarray, int]:
    """scipy, then `wave`, for a path or a file object."""
    try:
        import scipy.io.wavfile as wavfile

        sr, data = wavfile.read(source)
        return _pcm_to_float(data), int(sr)
    except Exception:  # noqa: BLE001 - scipy's errors vary by version; wave decides
        if hasattr(source, "seek"):
            source.seek(0)
        return _decode_with_wave(source)


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """-> (float32 waveform in [-1, 1], sample rate). Multichannel stays
    [C, L]; mono is [L]."""
    fast = native_io.read_wav_native(path)
    if fast is not None:
        return fast
    return _decode(path)


def _int16_pcm(wav: np.ndarray) -> np.ndarray:
    return (np.clip(wav, -1, 1) * 32767).astype(np.int16)


def write_wav(path: str, wav: np.ndarray, sample_rate: int = 16000) -> None:
    """16-bit PCM WAV out: the native encoder where it loads, else scipy,
    the same bytes."""
    wav = np.asarray(wav, dtype=np.float32)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if native_io.write_wav_native(path, wav, sample_rate):
        return
    import scipy.io.wavfile as wavfile

    # [C, L] channels first, as read_wav returns and the native encoder
    # interleaves -> scipy's [frames, channels]
    if wav.ndim == 2:
        wav = wav.T
    wavfile.write(path, sample_rate, _int16_pcm(wav))


def _to_clip(wav: np.ndarray, sr: int, target_sr: int, clip_seconds: float) -> np.ndarray:
    if wav.ndim > 1:
        wav = wav[0]
    if sr != target_sr:
        wav = resample_poly_np(wav, sr, target_sr)
    n = int(round(clip_seconds * target_sr))
    if wav.shape[0] < n:
        wav = np.pad(wav, (0, n - wav.shape[0]))
    else:
        wav = wav[:n]
    return wav.astype(np.float32)


def load_audio(path: str, target_sr: int = 16000,
               clip_seconds: float = 5.0) -> tuple[np.ndarray, int]:
    """The reference's `load_audio` contract: mono (first channel),
    resampled, exactly clip_seconds * target_sr samples (right-zero-pad or
    head crop)."""
    wav, sr = read_wav(path)
    return _to_clip(wav, sr, target_sr, clip_seconds), target_sr


def decode_wav_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """In-memory WAV decode (scipy, then `wave`), as `read_wav` returns."""
    return _decode(_io.BytesIO(data))


def load_audio_bytes(data: bytes, target_sr: int = 16000,
                     clip_seconds: float = 5.0) -> tuple[np.ndarray, int]:
    """The `load_audio` contract over in-memory WAV bytes."""
    wav, sr = decode_wav_bytes(data)
    return _to_clip(wav, sr, target_sr, clip_seconds), target_sr


def load_audio_chunks(path: str, target_sr: int = 16000, clip_seconds: float = 5.0,
                      hop_seconds: float | None = None) -> tuple[np.ndarray, np.ndarray]:
    """A file of any length as consecutive clip windows of the `load_audio`
    shape -> (chunks [N, clip_samples] f32, start samples [N] int64); hops
    of `hop_seconds` (default: the clip length), the last chunk
    right-zero-padded, at least one chunk."""
    wav, sr = read_wav(path)
    if wav.ndim > 1:
        wav = wav[0]
    if sr != target_sr:
        wav = resample_poly_np(wav, sr, target_sr)
    n = int(round(clip_seconds * target_sr))
    hop = n if hop_seconds is None else int(round(hop_seconds * target_sr))
    if hop <= 0:
        raise ValueError(f"hop_seconds must be positive, got {hop_seconds}")
    total = max(wav.shape[0], 1)
    # windows that start past the signal (hop > length) are dropped
    starts = [s for s in range(0, total, hop) if s < wav.shape[0]] or [0]
    chunks = np.zeros((len(starts), n), np.float32)
    for i, s in enumerate(starts):
        seg = wav[s : s + n]
        chunks[i, : seg.shape[0]] = seg
    return chunks, np.asarray(starts, np.int64)


def wav_to_bytes(wav: np.ndarray, sample_rate: int = 16000) -> bytes:
    """A float waveform as 16-bit PCM WAV bytes."""
    import scipy.io.wavfile as wavfile

    buf = _io.BytesIO()
    wavfile.write(buf, sample_rate, _int16_pcm(np.asarray(wav, dtype=np.float32)))
    return buf.getvalue()
