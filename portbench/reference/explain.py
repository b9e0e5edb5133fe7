"""The plain ADDvisor explanation of a batch of clips:

  wav -> STFT -> magnitude, phase -> UNet on the (freq_bins, frames) crop ->
  mask zero-padded to the full spectrum -> relevant / irrelevant magnitudes
  (log1p: expm1(m log1p |X|) and expm1((1 - m) log1p |X|); linear: m |X|
  and (1 - m) |X|) -> both waveforms by the inverse STFT with the clean
  phase -> the embedder over clean, relevant and irrelevant clips -> the
  LogReg head on the time-mean of the features -> three probabilities.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from portbench.reference import spectral, unet, wav2vec2


@contextlib.contextmanager
def precise():
    """float32 products in float32 (no TF32) and bfloat16 products summed in
    float32 throughout (no reduced-precision split reductions), restored
    after the block."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (m.allow_tf32, c.allow_tf32, m.allow_bf16_reduced_precision_reduction)
    m.allow_tf32 = c.allow_tf32 = m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32, m.allow_bf16_reduced_precision_reduction = before


def head(feats: torch.Tensor, w: dict) -> torch.Tensor:
    """features [B, T, H] -> sigmoid probabilities [B, 1] (f32)."""
    logits = feats.mean(dim=1) @ w["logreg.weight"] + w["logreg.bias"]
    return 1.0 / (1.0 + torch.exp(-logits))


def explain(w: dict, wav: torch.Tensor, cfg: dict, control: bool = False,
            embed_block: int = 16, with_magnitude: bool = False) -> dict:
    """wav [B, L] f32 -> {mask, relevant_wav, irrelevant_wav, probs_clean,
    probs_relevant, probs_irrelevant}; the embedder runs `embed_block` clips
    at a time; `with_magnitude` adds the clean |STFT|. Call it under
    `precise()`."""
    sc, uc = cfg["stft"], cfg["unet"]
    length = wav.shape[-1]
    spec = spectral.stft(wav.float(), sc)
    mag, phase = spec.abs(), torch.angle(spec)
    fb, fr = uc["freq_bins"], uc["frames"]
    mask = unet.forward(w, mag[:, :fb, :fr], uc, control=control)
    mask = F.pad(mask, (0, mag.shape[-1] - fr, 0, mag.shape[-2] - fb))
    if cfg["masking"] == "log1p":
        lm = torch.log1p(mag)
        rel, irr = torch.expm1(mask * lm), torch.expm1((1.0 - mask) * lm)
    else:
        rel, irr = mask * mag, (1.0 - mask) * mag
    waves = [spectral.istft(torch.polar(m, phase), sc, length) for m in (rel, irr)]
    probs = []
    for x in (wav, *waves):
        probs.append(torch.cat([
            head(wav2vec2.embed(w, x[i:i + embed_block], cfg["embedder"],
                                "control" if control else "stated"), w)
            for i in range(0, x.shape[0], embed_block)]))
    out = {"mask": mask, "relevant_wav": waves[0], "irrelevant_wav": waves[1],
           "probs_clean": probs[0], "probs_relevant": probs[1], "probs_irrelevant": probs[2]}
    if with_magnitude:
        out["magnitude"] = mag
    return out
