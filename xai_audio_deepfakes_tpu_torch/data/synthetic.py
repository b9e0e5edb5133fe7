"""Synthetic band-swap corpora with a known artifact band (port of
`data/synthetic.py`).

real clips   : voiced-speech stand-ins (random f0 harmonic stacks with a
               formant-like tilt, a syllable-rate envelope, a low noise floor)
artifact src : wideband noise at several times the speech RMS
manipulated  : a real clip with the source's complex STFT spliced into a
               band (magnitude and phase)

The clip generators are numpy and draw the same numbers from the same
`np.random.Generator` as the JAX package's. The splices and filters run on
tensors on their device: STFT by kernel B, inverse by kernel C, on the card.
The corpus functions take host arrays and a `device` and return host arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from xai_audio_deepfakes_tpu_torch.config import STFTConfig
from xai_audio_deepfakes_tpu_torch.data.bandswap import band_masks
from xai_audio_deepfakes_tpu_torch.device import resolve_device
from xai_audio_deepfakes_tpu_torch.ops.cuda_stft import istft, stft


def speechlike_clips(rng: np.random.Generator, n: int, num_samples: int,
                     sample_rate: int = 16000, max_harmonic_hz: float = 7600.0) -> np.ndarray:
    """[n, num_samples] f32 voiced-speech stand-ins: a harmonic stack at a
    random f0 in [110, 280] Hz with 1/k rolloff, a formant-like boost near
    500 Hz and random phases, a 2-6 Hz amplitude envelope, peak-normalised,
    plus a -26 dB white noise floor, scaled by 0.3."""
    t = np.arange(num_samples, dtype=np.float64) / sample_rate
    clips = np.empty((n, num_samples), np.float32)
    for i in range(n):
        f0 = rng.uniform(110.0, 280.0)
        n_harm = int(max_harmonic_hz // f0)
        k = np.arange(1, n_harm + 1)
        amp = (1.0 / k) * (1.0 + 3.0 * np.exp(-((k * f0 - 500.0) ** 2) / 2e5))
        phase = rng.uniform(0, 2 * np.pi, size=n_harm)
        sig = (amp[:, None] * np.sin(
            2 * np.pi * (k * f0)[:, None] * t[None, :] + phase[:, None]
        )).sum(axis=0)
        env = 0.55 + 0.45 * np.sin(
            2 * np.pi * rng.uniform(2.0, 6.0) * t + rng.uniform(0, 2 * np.pi)
        )
        sig = sig * env
        sig = sig / (np.max(np.abs(sig)) + 1e-9)
        sig = sig + 0.05 * rng.standard_normal(num_samples)
        clips[i] = (0.3 * sig).astype(np.float32)
    return clips


def noise_clips(rng: np.random.Generator, n: int, num_samples: int,
                rms: float = 0.5) -> np.ndarray:
    """[n, num_samples] wideband-noise artifact sources at a fixed RMS."""
    x = rng.standard_normal((n, num_samples)).astype(np.float32)
    return x * (rms / (np.sqrt(np.mean(x**2, axis=1, keepdims=True)) + 1e-9))


def band_indicator(stft_cfg: STFTConfig, lo_hz: float, hi_hz: float) -> np.ndarray:
    """[num_bins] 0/1 indicator of [lo_hz, hi_hz), bins at
    linspace(0, sr / 2, F)."""
    freqs = np.linspace(0, stft_cfg.sample_rate / 2, stft_cfg.num_bins)
    return ((freqs >= lo_hz) & (freqs < hi_hz)).astype(np.float32)


def per_clip_band_indicator(stft_cfg: STFTConfig, bands: np.ndarray) -> np.ndarray:
    """bands [B, 2] (lo_hz, hi_hz per clip) -> [B, num_bins] 0/1 indicators."""
    freqs = np.linspace(0, stft_cfg.sample_rate / 2, stft_cfg.num_bins)
    lo = np.asarray(bands)[:, 0:1]
    hi = np.asarray(bands)[:, 1:2]
    return ((freqs[None, :] >= lo) & (freqs[None, :] < hi)).astype(np.float32)


def _column(ind: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A [F] or [B, F] indicator as a [1 or B, F, 1] tensor beside `like`."""
    m = torch.as_tensor(np.ascontiguousarray(ind, np.float32), device=like.device)
    return (m[None] if m.ndim == 1 else m)[:, :, None]


def _splice(wav_real, wav_src, stft_cfg: STFTConfig, m: torch.Tensor) -> torch.Tensor:
    re_r, im_r = stft(wav_real, stft_cfg)
    re_s, im_s = stft(wav_src, stft_cfg)
    return istft(re_r * (1 - m) + re_s * m, im_r * (1 - m) + im_s * m, stft_cfg,
                 length=int(wav_real.shape[-1]))


def _filter(wav, stft_cfg: STFTConfig, m: torch.Tensor, keep_band: bool) -> torch.Tensor:
    re, im = stft(wav, stft_cfg)
    if not keep_band:
        m = 1.0 - m
    return istft(re * m, im * m, stft_cfg, length=int(wav.shape[-1]))


def splice_band(wav_real: torch.Tensor, wav_src: torch.Tensor, stft_cfg: STFTConfig,
                lo_hz: float, hi_hz: float) -> torch.Tensor:
    """[B, L] x2 -> [B, L]: the source's [lo, hi) band of the complex STFT
    spliced into the real clips, inverted."""
    return _splice(wav_real, wav_src, stft_cfg,
                   _column(band_indicator(stft_cfg, lo_hz, hi_hz), wav_real))


def band_filter(wav: torch.Tensor, stft_cfg: STFTConfig, lo_hz: float, hi_hz: float,
                keep_band: bool) -> torch.Tensor:
    """[B, L] -> [B, L]: the complex STFT zeroed outside (keep_band) or
    inside (not keep_band) [lo_hz, hi_hz), inverted."""
    return _filter(wav, stft_cfg, _column(band_indicator(stft_cfg, lo_hz, hi_hz), wav),
                   keep_band)


def splice_band_per_clip(wav_real: torch.Tensor, wav_src: torch.Tensor, stft_cfg: STFTConfig,
                         band_ind) -> torch.Tensor:
    """[B, L] x2 + [B, F] per-clip band indicators -> [B, L]: each source's
    own band spliced into its real clip."""
    return _splice(wav_real, wav_src, stft_cfg, _column(band_ind, wav_real))


def band_filter_per_clip(wav: torch.Tensor, stft_cfg: STFTConfig, band_ind,
                         keep_band: bool) -> torch.Tensor:
    """[B, L] + [B, F] -> [B, L]: each clip's complex STFT zeroed outside
    (keep_band) or inside (not keep_band) its own band, inverted."""
    return _filter(wav, stft_cfg, _column(band_ind, wav), keep_band)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def draw_anyband(rng: np.random.Generator, n: int, num_samples: int, sample_rate: int,
                 band_width: float = 1000.0, f_max: float = 8000.0,
                 noise_rms: float = 0.5) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """`make_anyband_corpus`'s draws from `rng`, in numpy: (real clips,
    noise sources, bands [n, 2] in Hz)."""
    real = speechlike_clips(rng, n, num_samples, sample_rate)
    src = noise_clips(rng, n, num_samples, rms=noise_rms)
    starts = rng.integers(0, int(f_max // band_width), size=n).astype(np.float64) * band_width
    return real, src, np.stack([starts, starts + band_width], axis=1)


@torch.inference_mode()
def make_anyband_corpus(
    rng: np.random.Generator,
    n: int,
    num_samples: int,
    stft_cfg: STFTConfig,
    band_width: float = 1000.0,
    f_max: float = 8000.0,
    noise_rms: float = 0.5,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (real [n, L], manipulated [n, L], bands [n, 2]): each clip's
    artifact band drawn uniformly from the grid of `band_width` bands in
    [0, f_max), so that a mask that explains must localise a different band
    per input."""
    dev = resolve_device(device)
    real, src, bands = draw_anyband(rng, n, num_samples, stft_cfg.sample_rate, band_width,
                                    f_max, noise_rms)
    ind = per_clip_band_indicator(stft_cfg, bands)
    manipulated = _host(splice_band_per_clip(torch.from_numpy(real).to(dev),
                                             torch.from_numpy(src).to(dev), stft_cfg, ind))
    return real, manipulated, bands


@torch.inference_mode()
def detector_corpus_anyband(
    real: np.ndarray,
    manipulated: np.ndarray,
    stft_cfg: STFTConfig,
    bands: np.ndarray,
    band_width: float = 1000.0,
    f_max: float = 8000.0,
    rng: np.random.Generator | None = None,
    n_random_masks: int = 4,
    sweep: bool = True,
    noise_rms: float = 0.5,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """-> (wavs [N, L], labels [N]) for anyband detector training.

    real -> 0 and the per-clip manipulated corpus -> 1; with `sweep`, fresh
    noise spliced into every real clip at every band of the grid -> 1 (the
    reference's per-file loop). Then the causal variants, per clip band:
    own band zeroed in the manipulated clip -> 0, own band only -> 1, a
    random band zeroed in the real clip -> 0, a random band only -> 0; and
    `n_random_masks` random spectral masks: the masked manipulated clip -> 1
    where the mask keeps more than 3/4 of its own band, -> 0 where it keeps
    at most 1/4, dropped in between; the masked real clip -> 0.
    """
    dev = resolve_device(device)
    wavs = [real, manipulated]
    labels = [np.zeros(len(real), np.int64), np.ones(len(manipulated), np.int64)]
    rt = torch.from_numpy(np.ascontiguousarray(real)).to(dev)
    mt = torch.from_numpy(np.ascontiguousarray(manipulated)).to(dev)
    ind = per_clip_band_indicator(stft_cfg, bands)
    length = real.shape[-1]
    rng = np.random.default_rng(0) if rng is None else rng

    if sweep:
        grid = band_masks(stft_cfg.num_bins, stft_cfg.sample_rate, band_width, f_max)
        for b in range(grid.shape[0]):
            src = noise_clips(rng, len(real), length, rms=noise_rms)
            one = np.broadcast_to(grid[b], (len(real), grid.shape[1]))
            wavs.append(_host(splice_band_per_clip(rt, torch.from_numpy(src).to(dev), stft_cfg,
                                                   one)))
            labels.append(np.ones(len(real), np.int64))

    rand_starts = rng.integers(0, int(f_max // band_width), size=len(real)).astype(
        np.float64) * band_width
    rand_ind = per_clip_band_indicator(
        stft_cfg, np.stack([rand_starts, rand_starts + band_width], axis=1))
    for src, bi, keep, lab in ((mt, ind, False, 0), (mt, ind, True, 1),
                               (rt, rand_ind, False, 0), (rt, rand_ind, True, 0)):
        wavs.append(_host(band_filter_per_clip(src, stft_cfg, bi, keep)))
        labels.append(np.full(src.shape[0], lab, np.int64))

    if n_random_masks:
        band_sizes = ind.sum(axis=1)  # [B]
        for _ in range(n_random_masks):
            m = random_spectral_mask(rng, stft_cfg)
            keep_frac = (ind * m[None, :]).sum(axis=1) / np.maximum(band_sizes, 1.0)
            for src_w, full_lab in ((mt, 1), (rt, 0)):
                out = _host(_filter(src_w, stft_cfg, _column(m, src_w), True))
                if full_lab == 1:
                    keep_sel = keep_frac > 0.75
                    zero_sel = keep_frac <= 0.25
                    if keep_sel.any():
                        wavs.append(out[keep_sel])
                        labels.append(np.ones(int(keep_sel.sum()), np.int64))
                    if zero_sel.any():
                        wavs.append(out[zero_sel])
                        labels.append(np.zeros(int(zero_sel.sum()), np.int64))
                else:
                    wavs.append(out)
                    labels.append(np.zeros(out.shape[0], np.int64))
    return np.concatenate(wavs), np.concatenate(labels)


@torch.inference_mode()
def detector_corpus(
    real: np.ndarray,
    manipulated: np.ndarray,
    stft_cfg: STFTConfig,
    lo_hz: float,
    hi_hz: float,
    augment: bool = True,
    rng: np.random.Generator | None = None,
    n_random_masks: int = 4,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """-> (wavs [N, L], labels [N]) for fixed-band detector training: real
    -> 0, manipulated -> 1; with `augment` the band-zeroed and band-only
    variants of both (-> 0, 1 for the manipulated clips; 0, 0 for the real
    ones) and, with `rng`, `n_random_masks` random spectral masks over every
    clip: masked real -> 0, masked manipulated -> 1 where the mask keeps
    more than 3/4 of [lo, hi), -> 0 where it keeps at most 1/4, dropped in
    between."""
    wavs = [real, manipulated]
    labels = [np.zeros(len(real), np.int64), np.ones(len(manipulated), np.int64)]
    if augment:
        dev = resolve_device(device)
        rt = torch.from_numpy(np.ascontiguousarray(real)).to(dev)
        mt = torch.from_numpy(np.ascontiguousarray(manipulated)).to(dev)
        for src, keep, lab in ((mt, False, 0), (mt, True, 1), (rt, False, 0), (rt, True, 0)):
            wavs.append(_host(band_filter(src, stft_cfg, lo_hz, hi_hz, keep)))
            labels.append(np.full(len(src), lab, np.int64))
        if rng is not None and n_random_masks:
            band = band_indicator(stft_cfg, lo_hz, hi_hz)
            for _ in range(n_random_masks):
                m = random_spectral_mask(rng, stft_cfg)
                keep_frac = float((m * band).sum() / max(band.sum(), 1.0))
                for src, full_lab in ((mt, 1), (rt, 0)):
                    if full_lab == 1 and 0.25 < keep_frac <= 0.75:
                        continue  # an ambiguous partial keep: dropped, not mislabelled
                    wavs.append(_host(_filter(src, stft_cfg, _column(m, src), True)))
                    lab = full_lab if keep_frac > 0.75 else 0
                    labels.append(np.full(len(src), lab, np.int64))
    return np.concatenate(wavs), np.concatenate(labels)


def random_spectral_mask(rng: np.random.Generator, stft_cfg: STFTConfig,
                         n_bands: int = 3) -> np.ndarray:
    """[num_bins] 0/1 mask: the union of `n_bands` random contiguous bands."""
    bins = stft_cfg.num_bins
    m = np.zeros(bins, np.float32)
    for _ in range(n_bands):
        w = int(rng.integers(bins // 16, bins // 2))
        s = int(rng.integers(0, bins - w))
        m[s : s + w] = 1.0
    return m


@torch.inference_mode()
def make_bandswap_corpus(
    rng: np.random.Generator,
    n: int,
    num_samples: int,
    stft_cfg: STFTConfig,
    lo_hz: float,
    hi_hz: float,
    noise_rms: float = 0.5,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """-> (real [n, L], manipulated [n, L]) with the artifact fixed to
    [lo_hz, hi_hz)."""
    dev = resolve_device(device)
    real = speechlike_clips(rng, n, num_samples, stft_cfg.sample_rate)
    src = noise_clips(rng, n, num_samples, rms=noise_rms)
    manipulated = _host(splice_band(torch.from_numpy(real).to(dev), torch.from_numpy(src).to(dev),
                                    stft_cfg, lo_hz, hi_hz))
    return real, manipulated
