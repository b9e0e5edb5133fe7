"""LMAC loss: the listenable-mask training objective (port of
`losses/lmac.py`).

    L = w_in * BCE(f(istft(mask * spec)), y_hat)
      + w_out * BCE(f(istft((1 - mask) * spec)), 1 - y_hat)
      + w_l1 * l1_scale * mean|mask|

f is embed -> time mean-pool -> LogReg, frozen, and differentiated through to
the mask. The weights w = softplus(w_raw) are learnable, raw init
[3.0, 0.5, 3.0]; after every optimiser step `renormalize_w` brings them back
to sum len(w), in raw-parameter space. The TV regulariser is off at
reg_w_tv = 0, as in the reference.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from xai_audio_deepfakes_tpu_torch.config import LossConfig
from xai_audio_deepfakes_tpu_torch.ops.masking import apply_mask, pad_mask_to_spec, remask_complex


def init_w_raw(cfg: LossConfig, device) -> torch.Tensor:
    """The learnable raw loss weights, a leaf that asks for a gradient."""
    return torch.tensor(cfg.w_init, dtype=torch.float32, device=device, requires_grad=True)


def softplus_weights(w_raw: torch.Tensor) -> torch.Tensor:
    return F.softplus(w_raw)


def _softplus_inverse(y: torch.Tensor) -> torch.Tensor:
    # softplus^-1(y) = y + log1p(-exp(-y)), numerically safe for y > 0
    return y + torch.log1p(-torch.exp(-torch.clamp(y, min=1e-6)))


def renormalize_w(w_raw: torch.Tensor, freeze_last: bool = False) -> torch.Tensor:
    """Post-step renorm: w <- w / sum(w) * len(w), mapped back through
    softplus^-1. With `freeze_last` the last raw entry passes through bit
    for bit and the others are renormalised among themselves to sum
    len(w) - 1."""
    w = F.softplus(w_raw)
    if freeze_last:
        head = w[:-1]
        head = head / head.sum() * (w.shape[0] - 1)
        return torch.cat([_softplus_inverse(head), w_raw[-1:]])
    return _softplus_inverse(w / w.sum() * w.shape[0])


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy with logits, in the stable form
    max(x, 0) - x t + log1p(exp(-|x|))."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def lmac_loss(
    w_raw: torch.Tensor,
    mask: torch.Tensor,
    magnitude: torch.Tensor,
    phase: torch.Tensor,
    class_pred: torch.Tensor,
    classify_wav: Callable[[torch.Tensor], torch.Tensor],
    istft_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    cfg: LossConfig = LossConfig(),
    l1_scale: float | torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (total, losses = [l_in, l_out, l1], w).

    mask [B, Fm, Tm] is the decoder's output, magnitude and phase [B, F, T]
    the clean STFT's, class_pred [B, 1] sigmoid(detector logits on the clean
    clip). classify_wav maps a waveform [B, L] to detector logits [B, 1];
    istft_fn maps (real, imag) [B, F, T] to a waveform [B, L]. `l1_scale`
    overrides `cfg.l1_scale` (the trainer's warmup ramp passes it)."""
    f, t = magnitude.shape[-2], magnitude.shape[-1]
    mask_full = pad_mask_to_spec(mask, f, t)
    rel_mag, irr_mag = apply_mask(mask_full, magnitude, cfg.masking)
    rel_logits = classify_wav(istft_fn(*remask_complex(rel_mag, phase)))
    irr_logits = classify_wav(istft_fn(*remask_complex(irr_mag, phase)))

    l_in = bce_with_logits(rel_logits, class_pred)
    l_out = bce_with_logits(irr_logits, 1.0 - class_pred)
    l1 = (cfg.l1_scale if l1_scale is None else l1_scale) * mask.abs().mean()

    losses = torch.stack([l_in, l_out, l1])
    w = softplus_weights(w_raw)
    total = (w * losses).sum()
    if cfg.reg_w_tv > 0:
        tv_h = (mask[..., :, :-1] - mask[..., :, 1:]).abs().sum()
        tv_w = (mask[..., :-1, :] - mask[..., 1:, :]).abs().sum()
        total = total + cfg.reg_w_tv * (tv_h + tv_w)
    return total, losses, w
