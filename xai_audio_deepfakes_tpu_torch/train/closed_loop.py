"""Closed-loop explanation-quality protocol (port of `train/closed_loop.py`):
show that the masks explain.

  1. build a band-swap corpus whose artifact band is KNOWN
     (`data/synthetic.py`), fixed or, with `anyband`, drawn per clip;
  2. train the LogReg detector on (real = 0, manipulated = 1) embeddings
     (`train/train_logreg.py`);
  3. train the mask decoder against that trained detector with the LMAC
     loss (`train/train_addvisor.py`);
  4. score the product claim: the LMAC metrics before and after training,
     how much of each mask sits in its clip's band
     (`metrics/localization.py`), and whether the relevant waveform keeps
     the detector's decision while the irrelevant one flips it.

No step reads external weights: the embedder keeps its random weights (a
fixed random feature map; the detector head is what makes it a detector).

One seed gives the JAX package's clips and batch orders: the numpy `rng` is
consumed in its order (the training and evaluation corpora, the detector
corpus, one shuffle per epoch). The weights are the pipeline's: built from
`seed` by default, or the caller's `pipe`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from xai_audio_deepfakes_tpu_torch.config import (
    EmbedderConfig,
    MaskingConvention,
    PipelineConfig,
    TrainConfig,
    manipulated_probability,
)
from xai_audio_deepfakes_tpu_torch.data.synthetic import (
    detector_corpus,
    detector_corpus_anyband,
    make_anyband_corpus,
    make_bandswap_corpus,
)
from xai_audio_deepfakes_tpu_torch.metrics.lmac_metrics import summarize
from xai_audio_deepfakes_tpu_torch.metrics.localization import (
    mask_band_stats,
    per_clip_band_stats,
)
from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline
from xai_audio_deepfakes_tpu_torch.train.train_addvisor import train_addvisor
from xai_audio_deepfakes_tpu_torch.train.train_logreg import evaluate_logreg, train_detector


def anyband_protocol_config() -> PipelineConfig:
    """The configuration the JAX package's `cli closed-loop` builds for the
    anyband protocol's command line (`--anyband --scan-layers --remat
    --remat-policy dots --dtype bfloat16`, `docs/closed_loop_anyband`), with
    the command's defaults: decoder lr 3e-4, linear loss masking, f32 UNet,
    the unfused bf16 frontend. Its run also takes noise rms 1.0 and batch
    16."""
    return PipelineConfig(
        embedder=EmbedderConfig(dtype="bfloat16", scan_layers=True, remat=True,
                                remat_policy="dots"),
        train=TrainConfig(model_lr=3e-4))


def _batches(wavs: np.ndarray, batch_size: int):
    """(clips padded to `batch_size` by repeating the last, how many are
    real) for each batch: a ragged tail is padded and its outputs trimmed,
    so every clip is scored and every call has one shape."""
    for i in range(0, len(wavs), batch_size):
        chunk = wavs[i:i + batch_size]
        k = len(chunk)
        if k < batch_size:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], batch_size - k, axis=0)])
        yield chunk, k


def evaluate_explanations(
    pipe: ADDvisorPipeline,
    wavs: np.ndarray,
    band: tuple[float, float] | None,
    masking: MaskingConvention,
    batch_size: int,
    keep_wavs: int = 0,
    decoder: str = "unet",
    bands: np.ndarray | None = None,
    band_width: float = 1000.0,
    f_max: float = 8000.0,
) -> dict:
    """Explain manipulated clips with the pipeline's weights and score the
    product claim: LMAC metrics, mask-vs-band localisation and the decision
    keep / flip rates. With `keep_wavs` > 0 the first that many clips'
    relevant and irrelevant waveforms are returned too.

    `band` scores every mask against one corpus-wide band; `bands` [B, 2]
    scores each mask against its own clip's band, with the input-dependence
    statistics of `per_clip_band_stats` (the anyband protocol)."""
    masks, mags, pc, pr, pi, rel_wavs, irr_wavs = [], [], [], [], [], [], []
    done = 0
    for chunk, k in _batches(wavs, batch_size):
        out = pipe.explain(chunk, decoder=decoder, masking=masking)
        masks.append(out.mask[:k].cpu())
        mags.append(out.magnitude[:k].cpu())
        pc.append(out.probs_clean[:k].cpu())
        pr.append(out.probs_relevant[:k].cpu())
        pi.append(out.probs_irrelevant[:k].cpu())
        if done < keep_wavs:
            rel_wavs.append(out.relevant_wav[:k][:keep_wavs - done].cpu().numpy())
            irr_wavs.append(out.irrelevant_wav[:k][:keep_wavs - done].cpu().numpy())
        done += k
    masks = torch.cat(masks).numpy()
    pc, pr, pi = (torch.cat(x) for x in (pc, pr, pi))
    metrics = {k: float(v) for k, v in summarize(pc, pr, pi).items()}
    pol = pipe.cfg.polarity
    p_clean, p_rel, p_irr = (manipulated_probability(p[:, 0], pol).numpy() for p in (pc, pr, pi))
    uc = pipe.cfg.unet
    if bands is not None:
        localization = per_clip_band_stats(masks, pipe.cfg.stft, bands, band_width, f_max,
                                           freq_bins=uc.freq_bins, frames=uc.frames)
    else:
        localization = mask_band_stats(masks, pipe.cfg.stft, band[0], band[1],
                                       freq_bins=uc.freq_bins, frames=uc.frames)
    return {
        "metrics": metrics,
        "localization": localization,
        "p_manipulated_clean": float(p_clean.mean()),
        "p_manipulated_relevant": float(p_rel.mean()),
        "p_manipulated_irrelevant": float(p_irr.mean()),
        # on manipulated inputs the relevant part must KEEP the manipulated
        # call and the irrelevant part must FLIP it to real
        "keep_rate": float(np.mean(p_rel > 0.5)),
        "flip_rate": float(np.mean(p_irr < 0.5)),
        "masks": masks,
        "magnitude": torch.cat(mags).numpy(),
        "relevant_wavs": np.concatenate(rel_wavs) if rel_wavs else None,
        "irrelevant_wavs": np.concatenate(irr_wavs) if irr_wavs else None,
        # per clip P(class 1) of the clean, relevant and irrelevant clips
        "probs": torch.cat([pc, pr, pi], dim=1).numpy(),
    }


def run_closed_loop(
    cfg: PipelineConfig,
    seed: int = 0,
    n_train: int = 32,
    n_eval: int = 16,
    band: tuple[float, float] = (2000.0, 3000.0),
    epochs: int = 40,
    batch_size: int = 8,
    noise_rms: float = 0.5,
    log_fn: Callable[[dict], None] | None = None,
    artifact_fn=None,
    checkpoint_fn=None,
    keep_wavs: int = 0,
    anyband: bool = False,
    band_width: float = 1000.0,
    f_max: float = 8000.0,
    decoder: str = "unet",
    l1_scale: float | None = None,
    l1_warmup_epochs: int = 0,
    device="cuda",
    pipe: ADDvisorPipeline | None = None,
) -> dict:
    """The whole loop. Returns the detector's metrics (on its held-out split
    and on the evaluation corpus), the before / after / after-train
    explanation metrics, localisation and keep / flip rates, the training
    log, the final evaluation masks and waveforms, and the train state.

    With `anyband` each clip's artifact band is drawn from the grid of
    `band_width` bands in [0, f_max) and localisation is scored per clip
    (`band` is ignored). `pipe` (default: a new pipeline on `device` with
    weights from `seed`) gets the fitted detector head, and its mask
    decoder is trained in place."""
    rng = np.random.default_rng(seed)
    n_samples, sc = cfg.audio.num_samples, cfg.stft
    pipe = ADDvisorPipeline(cfg, device=device, seed=seed) if pipe is None else pipe
    dev = pipe.device
    bands_tr = bands_ev = None
    if anyband:
        real_tr, manip_tr, bands_tr = make_anyband_corpus(
            rng, n_train, n_samples, sc, band_width, f_max, noise_rms, device=dev)
        real_ev, manip_ev, bands_ev = make_anyband_corpus(
            rng, n_eval, n_samples, sc, band_width, f_max, noise_rms, device=dev)
    else:
        real_tr, manip_tr = make_bandswap_corpus(rng, n_train, n_samples, sc, band[0], band[1],
                                                 noise_rms, device=dev)
        real_ev, manip_ev = make_bandswap_corpus(rng, n_eval, n_samples, sc, band[0], band[1],
                                                 noise_rms, device=dev)

    # the detector: real = 0 vs manipulated = 1 on mean-pooled embeddings,
    # with band-filtered augmentation so that its decision survives masking
    def embed_all(wavs: np.ndarray) -> np.ndarray:
        return np.concatenate([pipe.features(chunk).mean(dim=1)[:k].cpu().numpy()
                               for chunk, k in _batches(wavs, batch_size)])

    if anyband:
        det_wavs, y = detector_corpus_anyband(real_tr, manip_tr, sc, bands_tr, band_width, f_max,
                                              rng=rng, noise_rms=noise_rms, device=dev)
    else:
        det_wavs, y = detector_corpus(real_tr, manip_tr, sc, band[0], band[1], rng=rng,
                                      device=dev)
    det_params, det_metrics = train_detector(embed_all(det_wavs), y, log_fn=log_fn, device=dev)
    # held out: the evaluation corpus, un-augmented
    x_ev = np.concatenate([embed_all(real_ev), embed_all(manip_ev)])
    y_ev = np.concatenate([np.zeros(len(real_ev), np.int64), np.ones(len(manip_ev), np.int64)])
    det_holdout = evaluate_logreg(det_params, x_ev, y_ev)
    pipe.logreg = det_params

    masking = cfg.loss.masking
    loc_kw = dict(band_width=band_width, f_max=f_max, decoder=decoder)
    before = evaluate_explanations(pipe, manip_ev, band, masking, batch_size, bands=bands_ev,
                                   **loc_kw)

    order = np.arange(n_train)

    def batches():
        rng.shuffle(order)
        return [manip_tr[order[i:i + batch_size]]
                for i in range(0, n_train - batch_size + 1, batch_size)]

    train_log: list[dict] = []

    def _log(rec):
        train_log.append(rec)
        if log_fn is not None:
            log_fn(rec)

    state = train_addvisor(pipe, batches, num_epochs=epochs, log_fn=_log,
                           artifact_fn=artifact_fn, checkpoint_fn=checkpoint_fn, decoder=decoder,
                           l1_scale=l1_scale, l1_warmup_epochs=l1_warmup_epochs)

    after = evaluate_explanations(pipe, manip_ev, band, masking, batch_size, keep_wavs=keep_wavs,
                                  bands=bands_ev, **loc_kw)
    # the training clips: "the loss minimum localises" apart from "the
    # decoder generalises to held-out clips"
    n_sub = len(manip_ev)
    after_train = evaluate_explanations(
        pipe, manip_tr[:n_sub], band, masking, batch_size,
        bands=None if bands_tr is None else bands_tr[:n_sub], **loc_kw)

    arrays = ("masks", "magnitude", "relevant_wavs", "irrelevant_wavs", "probs")
    return {
        "final_probs": after["probs"],
        "band_hz": None if anyband else list(band),
        "anyband": anyband,
        "decoder": decoder,
        "masking": str(getattr(masking, "value", masking)),
        "eval_bands_hz": None if bands_ev is None else bands_ev.tolist(),
        "detector": det_metrics,
        "detector_holdout": det_holdout,
        "before": {k: v for k, v in before.items() if k not in arrays},
        "after": {k: v for k, v in after.items() if k not in arrays},
        "after_train": {k: v for k, v in after_train.items() if k not in arrays},
        "train_log": train_log,
        "final_masks": after["masks"],
        "final_magnitude": after["magnitude"],
        "final_relevant_wavs": after["relevant_wavs"],
        "final_irrelevant_wavs": after["irrelevant_wavs"],
        "eval_manipulated": manip_ev,
        "state": state,
    }
