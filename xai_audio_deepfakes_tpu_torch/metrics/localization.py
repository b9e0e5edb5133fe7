"""Mask-localisation scoring against a known artifact band (port of
`metrics/localization.py`; numpy on the host).

The closed loop builds corpora whose artifact band is known ground truth,
so localisation is a checkable number: how much of a mask's mass sits
inside the band the detector keys on. Every statistic is taken over the
decoder's support (the cropped (freq_bins, frames) region): the zero
padding `pad_mask_to_spec` adds outside the crop is a constant of the
pipeline, not the decoder's behaviour.
"""

from __future__ import annotations

import numpy as np

from xai_audio_deepfakes_tpu_torch.config import STFTConfig
from xai_audio_deepfakes_tpu_torch.data.bandswap import band_masks
from xai_audio_deepfakes_tpu_torch.data.synthetic import band_indicator, per_clip_band_indicator


def per_clip_band_stats(
    masks: np.ndarray,
    stft_cfg: STFTConfig,
    bands: np.ndarray,
    band_width: float = 1000.0,
    f_max: float = 8000.0,
    freq_bins: int | None = None,
    frames: int | None = None,
    threshold: float = 0.5,
) -> dict:
    """masks [B, F, T] + per-clip bands [B, 2] -> input-dependence stats.

    The anyband protocol's scoring: the reference's detector is trained on
    ANY of the grid's 1 kHz bands per clip (`train_logReg_swapping.py:70-92`;
    checkpoint `logReg_vocoded_anyband.joblib`, `classifier_embedder.py:12`),
    so a faithful mask must track each clip's OWN band. Three families of
    statistics separate "learned to localize evidence" from "learned one
    static filter":

      own_* vs wrong-band control:
        own_iou_mean        mean IoU of (mask>thr) vs the clip's own band
        other_iou_mean      mean IoU vs the grid's OTHER bands (a constant
                            band-pass mask matches some wrong band as well
                            as its own; must be << own_iou_mean)
        own_in_band_mean / own_out_band_mean: mean mask value inside /
                            outside each clip's own band

      cross-clip mask similarity (input-dependence):
        cross_band_pair_iou mean pairwise IoU between hard masks of clips
                            with DIFFERENT bands — a constant mask scores
                            ~1.0; an input-dependent one is low
        same_band_pair_iou  same, clips sharing a band (consistency; should
                            exceed cross_band_pair_iou)
        mask_std_across_clips  mean over (F, T) of the std of mask values
                            across clips (0 for any constant mask)

      per_clip: [{band_lo, band_hi, iou, in_band_mean, out_band_mean}, ...]
    """
    masks = np.asarray(masks, np.float32)
    if freq_bins is not None or frames is not None:
        masks = masks[
            :, : freq_bins or masks.shape[1], : frames or masks.shape[2]
        ]
    b, f, t = masks.shape
    bands = np.asarray(bands, np.float64)
    grid = band_masks(
        stft_cfg.num_bins, stft_cfg.sample_rate, band_width, f_max
    )[:, :f]  # [n_bands, F]
    band_idx = np.rint(bands[:, 0] / band_width).astype(np.int64)
    own = per_clip_band_indicator(stft_cfg, bands)[:, :f]  # [B, F]

    # soft per-clip in/out means vs own band
    n_in = own.sum(axis=1) * t
    n_out = (1 - own).sum(axis=1) * t
    in_means = (masks * own[:, :, None]).sum(axis=(1, 2)) / np.maximum(n_in, 1)
    out_means = (masks * (1 - own)[:, :, None]).sum(axis=(1, 2)) / np.maximum(
        n_out, 1
    )

    # hard-mask IoU of every clip vs every grid band
    hard = masks > threshold  # [B, F, T]
    hard_f = hard.reshape(b, f * t).astype(np.float32)
    cnt = hard_f.sum(axis=1)  # [B]
    inter = np.einsum("bft,jf->bj", hard.astype(np.float32), grid)  # [B, nb]
    band_area = grid.sum(axis=1) * t  # [nb]
    union = cnt[:, None] + band_area[None, :] - inter
    iou = inter / np.maximum(union, 1.0)  # [B, n_bands]
    own_iou = iou[np.arange(b), band_idx]
    others = np.ones_like(iou, bool)
    others[np.arange(b), band_idx] = False
    other_iou = iou[others].reshape(b, -1).mean(axis=1)

    # pairwise hard-mask IoU, split by whether the pair shares a band
    pair_inter = hard_f @ hard_f.T  # [B, B]
    pair_union = cnt[:, None] + cnt[None, :] - pair_inter
    pair_iou = pair_inter / np.maximum(pair_union, 1.0)
    same = band_idx[:, None] == band_idx[None, :]
    off_diag = ~np.eye(b, dtype=bool)
    cross_sel = (~same) & off_diag
    same_sel = same & off_diag
    cross_pair = float(pair_iou[cross_sel].mean()) if cross_sel.any() else None
    same_pair = float(pair_iou[same_sel].mean()) if same_sel.any() else None

    return {
        "own_iou_mean": float(own_iou.mean()),
        "own_iou_min": float(own_iou.min()),
        "other_iou_mean": float(other_iou.mean()),
        "own_in_band_mean": float(in_means.mean()),
        "own_out_band_mean": float(out_means.mean()),
        "cross_band_pair_iou": cross_pair,
        "same_band_pair_iou": same_pair,
        "mask_std_across_clips": float(masks.std(axis=0).mean()),
        "per_clip": [
            {
                "band_lo": float(bands[i, 0]),
                "band_hi": float(bands[i, 1]),
                "iou": float(own_iou[i]),
                "in_band_mean": float(in_means[i]),
                "out_band_mean": float(out_means[i]),
            }
            for i in range(b)
        ],
    }


def mask_band_stats(
    mask: np.ndarray,
    stft_cfg: STFTConfig,
    lo_hz: float,
    hi_hz: float,
    freq_bins: int | None = None,
    frames: int | None = None,
    threshold: float = 0.5,
) -> dict:
    """mask [B, F, T] (full-spec, as `ExplainOutput.mask`) -> localization
    stats vs the [lo_hz, hi_hz) band:

      in_band_mean / out_band_mean : mean mask value inside/outside the band
      concentration               : in_band_mean / out_band_mean
      energy_fraction             : share of total mask mass in the band
      band_fraction               : share of bins the band occupies (the
                                    energy_fraction of a uniform mask)
      selectivity                 : energy_fraction / band_fraction
      iou                         : IoU of (mask > threshold) vs the band
    """
    mask = np.asarray(mask, np.float32)
    if freq_bins is not None or frames is not None:
        mask = mask[:, : freq_bins or mask.shape[1], : frames or mask.shape[2]]
    ind = band_indicator(stft_cfg, lo_hz, hi_hz)[: mask.shape[1]]
    in_b = ind[None, :, None]
    n_in = float(ind.sum()) * mask.shape[0] * mask.shape[2]
    n_out = float((1 - ind).sum()) * mask.shape[0] * mask.shape[2]
    in_mean = float((mask * in_b).sum() / max(n_in, 1.0))
    out_mean = float((mask * (1 - in_b)).sum() / max(n_out, 1.0))
    total = float(mask.sum())
    energy_frac = float((mask * in_b).sum() / max(total, 1e-12))
    band_frac = float(ind.sum() / mask.shape[1])
    hard = mask > threshold
    band_full = np.broadcast_to(in_b.astype(bool), mask.shape)
    inter = float(np.logical_and(hard, band_full).sum())
    union = float(np.logical_or(hard, band_full).sum())
    return {
        "in_band_mean": in_mean,
        "out_band_mean": out_mean,
        "concentration": in_mean / max(out_mean, 1e-9),
        "energy_fraction": energy_frac,
        "band_fraction": band_frac,
        "selectivity": energy_frac / max(band_frac, 1e-9),
        "iou": inter / max(union, 1.0),
    }
