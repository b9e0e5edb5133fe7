"""The plain LMAC training step of the UNet mask decoder, as ADDvisor trains
it:

  collate, without gradient: the STFT of the clean clips, and the target
    sigmoid(head(embed(wav))) from the frozen embedder and head;
  forward: the UNet in training mode (BatchNorm on the batch's statistics)
    on the magnitude's crop, the mask zero-padded to the spectrum, the
    relevant and irrelevant magnitudes (linear: m |X| and (1 - m) |X|),
    both waveforms by the inverse STFT with the clean phase, the head's
    logits of each through the embedder;
  loss: l_in = BCE(relevant logits, target), l_out = BCE(irrelevant logits,
    1 - target), l1 = l1_scale mean |m|, total = softplus(w_raw) . [l_in,
    l_out, l1]; BCE with logits in its stable form, averaged;
  update: Adam (betas 0.9, 0.999, eps 1e-8 outside the root) on the UNet's
    parameters (lr model_lr) and on w_raw (lr loss_w_lr), then w_raw brought
    back to softplus weights that sum to len(w): w <- w / sum(w) len(w),
    mapped through softplus^-1(y) = y + log1p(-exp(-y)).

The gradient reaches the mask through the frozen embedder and the inverse
STFT. The embedder computes in the configuration's arithmetic
(`wav2vec2.embed`), the UNet in its stated dtype (the control one step
lower).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import spectral, unet, wav2vec2

BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def unet_parameters(w: dict, c: int) -> list:
    """The names of the UNet's trained parameters (convs, BatchNorm scales
    and shifts), in a fixed order."""
    names = [n + s for n in unet.conv_shapes(c) for s in (".weight", ".bias")]
    return names + [n + s for n in unet.batch_norms(c) for s in (".weight", ".bias")]


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def _softplus_inverse(y: torch.Tensor) -> torch.Tensor:
    return y + torch.log1p(-torch.exp(-torch.clamp(y, min=1e-6)))


class Trainer:
    """The reference's training state: its own float32 copies of the UNet's
    parameters and running statistics, w_raw, and Adam's moments."""

    def __init__(self, w: dict, cfg: dict, loss: dict, train: dict, control: bool = False):
        self.w, self.cfg, self.loss, self.train, self.control = dict(w), cfg, loss, train, control
        self.names = unet_parameters(w, cfg["unet"]["base_channels"])
        for n in self.names:
            self.w[n] = w[n].detach().float().clone().requires_grad_(True)
        self.w_raw = torch.tensor(loss["w_init"], dtype=torch.float32,
                                  device=w[self.names[0]].device, requires_grad=True)
        self.moments = {}
        self.t = 0

    def parameters(self) -> dict:
        out = {n: self.w[n] for n in self.names}
        out["w_raw"] = self.w_raw
        return out

    def _logits(self, wav: torch.Tensor) -> torch.Tensor:
        feats = wav2vec2.embed(self.w, wav, self.cfg["embedder"],
                               "control" if self.control else "stated")
        return feats.mean(dim=1) @ self.w["logreg.weight"] + self.w["logreg.bias"]

    def step(self, wav: torch.Tensor) -> dict:
        """One step on wav [B, L] -> {"loss", "l_in", "l_out", "l1" (floats),
        "grads" ({name: the gradient Adam took})}."""
        cfg, uc, sc = self.cfg, self.cfg["unet"], self.cfg["stft"]
        with torch.no_grad():
            spec = spectral.stft(wav.float(), sc)
            mag, phase = spec.abs(), torch.angle(spec)
            target = torch.sigmoid(self._logits(wav))
        fb, fr = uc["freq_bins"], uc["frames"]
        mask = unet.forward(self.w, mag[:, :fb, :fr], uc, control=self.control, train=True)
        full = F.pad(mask, (0, mag.shape[-1] - fr, 0, mag.shape[-2] - fb))
        if self.loss["masking"] == "log1p":
            lm = torch.log1p(mag)
            rel, irr = torch.expm1(full * lm), torch.expm1((1.0 - full) * lm)
        else:
            rel, irr = full * mag, (1.0 - full) * mag
        length = wav.shape[-1]
        logits = [self._logits(spectral.istft(torch.polar(m, phase), sc, length))
                  for m in (rel, irr)]
        l_in = bce_with_logits(logits[0], target)
        l_out = bce_with_logits(logits[1], 1.0 - target)
        l1 = self.loss["l1_scale"] * mask.abs().mean()
        losses = torch.stack([l_in, l_out, l1])
        total = (F.softplus(self.w_raw) * losses).sum()
        params = self.parameters()
        grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
        self._adam(params, grads)
        with torch.no_grad():
            w = F.softplus(self.w_raw)
            self.w_raw.copy_(_softplus_inverse(w / w.sum() * w.shape[0]))
        return {"loss": float(total.detach()), "l_in": float(l_in.detach()),
                "l_out": float(l_out.detach()), "l1": float(l1.detach()),
                "grads": {k: g.detach() for k, g in grads.items()}}

    @torch.no_grad()
    def _adam(self, params: dict, grads: dict) -> None:
        self.t += 1
        b1, b2 = BETAS
        for name, p in params.items():
            g = grads[name]
            m, v = self.moments.get(name, (torch.zeros_like(p), torch.zeros_like(p)))
            m = b1 * m + (1.0 - b1) * g
            v = b2 * v + (1.0 - b2) * g * g
            self.moments[name] = (m, v)
            lr = self.train["loss_w_lr"] if name == "w_raw" else self.train["model_lr"]
            m_hat = m / (1.0 - b1 ** self.t)
            v_hat = v / (1.0 - b2 ** self.t)
            p -= lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
