"""Vocoded-dataset generation (port of `data/vocoded.py`, the reference's
`hifigan.py` app).

For each source clip:
  1. the log-mel spectrogram (hop 256, Hann 1024, 80 slaney mels) and the
     HiFi-GAN back to a waveform (`make_vocoder_fn`: `pipe.vocode`, kernel B
     for the mel's STFT);
  2. cross-correlation alignment of the vocoded clip with its source
     (`ops/align.py`);
  3. Hann-1024 / hop-256 STFTs of both and the per-1-kHz-band complex splice
     over 0-8 kHz (`data/bandswap.py`: kernel B twice, kernel C once for the
     eight bands), with an out-of-band leakage warning above 1e-6;
  4. `{name}_vocoded_{start}-{end}.wav` written (`data/io.py`).
"""

from __future__ import annotations

import os
from typing import Callable, Iterable

import numpy as np
import torch

from xai_audio_deepfakes_tpu_torch.config import STFTConfig
from xai_audio_deepfakes_tpu_torch.data.bandswap import band_spliced_waveforms
from xai_audio_deepfakes_tpu_torch.data.io import load_audio, write_wav
from xai_audio_deepfakes_tpu_torch.device import resolve_device
from xai_audio_deepfakes_tpu_torch.ops.align import align_waveforms


def hann_splice_config(sample_rate: int = 16000) -> STFTConfig:
    """The data-generation STFT: a full Hann-1024 window, hop 256, distinct
    from the pipeline's rect-644 / hop-322."""
    return STFTConfig(sample_rate=sample_rate, n_fft=1024, hop_length=256, win_length=1024,
                      window="hann")


def make_vocoder_fn(pipe) -> Callable[[torch.Tensor], torch.Tensor]:
    """wav [B, L] -> vocoded wav [B, ~L] on the pipeline's device (mel ->
    HiFi-GAN with the pipeline's generator)."""
    return pipe.vocode


@torch.inference_mode()
def generate_vocoded_dataset(
    file_names: Iterable[str],
    wav_dir: str,
    output_dir: str,
    vocode_fn: Callable[[torch.Tensor], torch.Tensor],
    clip_seconds: float = 5.0,
    band_width: float = 1000.0,
    f_max: float = 8000.0,
    leakage_warn: float = 1e-6,
    log_fn: Callable[[dict], None] | None = None,
    device="cuda",
) -> int:
    """Writes the band-spliced wavs of every file of `file_names` found in
    `wav_dir` (missing ones are skipped) and returns how many. `vocode_fn`
    takes and returns tensors on `device`; the splices run there too, the
    alignment's correlation as well."""
    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    cfg = hann_splice_config()
    written = 0
    for name in file_names:
        path = os.path.join(wav_dir, name)
        if not os.path.exists(path):
            continue
        wav, sr = load_audio(path, clip_seconds=clip_seconds)
        voc = vocode_fn(torch.from_numpy(np.ascontiguousarray(wav[None], np.float32)).to(dev))
        ref_a, voc_a = align_waveforms(wav, voc[0].float().cpu().numpy(), device=dev)
        waves, leakage = band_spliced_waveforms(
            torch.from_numpy(np.ascontiguousarray(ref_a)).to(dev),
            torch.from_numpy(np.ascontiguousarray(voc_a)).to(dev), cfg,
            band_width=band_width, f_max=f_max, length=len(ref_a))
        waves, leak = waves.cpu().numpy(), leakage.cpu().numpy()
        for b, start in enumerate(np.arange(0, f_max, band_width)):
            end = start + band_width
            if leak[b] > leakage_warn and log_fn is not None:
                log_fn({"warning": "band-splice leakage", "file": name,
                        "band": f"{int(start)}-{int(end)}", "leakage": float(leak[b])})
            write_wav(os.path.join(output_dir, f"{name}_vocoded_{int(start)}-{int(end)}.wav"),
                      waves[b], sr)
            written += 1
    return written
