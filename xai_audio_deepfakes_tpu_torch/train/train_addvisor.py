"""Mask-decoder training (port of `train/train_addvisor.py`).

Training semantics, as in the JAX package:
  * decoder="unet": the UNet on the STFT magnitude; decoder="features": the
    feature decoder on the clean clip's SSL features, whose one embed also
    gives the target (no BatchNorm, so no batch statistics)
  * LMAC loss with sigmoid(detector logits on the clean clip) as the target
  * two Adam optimisers: lr 3e-5 for the decoder, lr 1e-4 for the raw loss
    weights
  * post-step renorm of w to sum = len(w)
  * the frozen embedder and LogReg head sit inside the differentiated graph:
    a step is three embedder forwards and two backwards

Differences from the JAX step, which is a pure function of a state pytree:
the state here owns the decoder module and the optimisers, and a step
updates them in place (the decoder is the pipeline's own `unet` or
`feat_decoder`, so the pipeline explains with the trained decoder
afterwards). The STFT and the clean embed run under `no_grad`, outside the
graph.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from xai_audio_deepfakes_tpu_torch.config import PipelineConfig
from xai_audio_deepfakes_tpu_torch.data.prefetch import prefetch, to_device
from xai_audio_deepfakes_tpu_torch.device import deterministic_cudnn
from xai_audio_deepfakes_tpu_torch.losses.lmac import (
    init_w_raw,
    lmac_loss,
    renormalize_w,
    softplus_weights,
)
from xai_audio_deepfakes_tpu_torch.models.logreg import logreg_apply
from xai_audio_deepfakes_tpu_torch.models.unet import load_reference_state_dict
from xai_audio_deepfakes_tpu_torch.ops.masking import crop_spec
from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline
from xai_audio_deepfakes_tpu_torch.train.checkpoints import load_checkpoint


def decoder_params_key(decoder: str) -> str:
    """The parameter-tree key (and pipeline attribute) of the trainable mask
    decoder."""
    if decoder == "unet":
        return "unet"
    if decoder == "features":
        return "feat_decoder"
    raise ValueError(f"unknown decoder {decoder!r}")


def _check_trainable(cfg: PipelineConfig, decoder: str) -> None:
    if decoder_params_key(decoder) == "unet" and cfg.unet.dtype != "float32":
        raise NotImplementedError(
            "training the bf16 UNet (UNetConfig.dtype=bfloat16) is not ported yet "
            "(ROADMAP.md Queue 1 item 7)")


def make_optimizers(cfg: PipelineConfig, decoder_params, w_raw: torch.Tensor):
    """(Adam for the decoder, Adam for the raw loss weights), both with
    betas (0.9, 0.999) and eps 1e-8 outside the root, as `optax.adam`."""
    return (torch.optim.Adam(decoder_params, lr=cfg.train.model_lr),
            torch.optim.Adam([w_raw], lr=cfg.train.loss_w_lr))


class AddvisorTrainState:
    """Everything that evolves during training: the decoder (parameters and
    BatchNorm running statistics), the raw loss weights, both optimisers and
    the step count. The frozen embedder and LogReg head stay in the pipeline."""

    def __init__(self, decoder: torch.nn.Module, w_raw: torch.Tensor,
                 opt_model: torch.optim.Optimizer, opt_w: torch.optim.Optimizer, step: int = 0):
        self.decoder, self.w_raw = decoder, w_raw
        self.opt_model, self.opt_w, self.step = opt_model, opt_w, step

    def state_dict(self) -> dict:
        return {"decoder": self.decoder.state_dict(), "w_raw": self.w_raw.detach(),
                "opt_model": self.opt_model.state_dict(), "opt_w": self.opt_w.state_dict(),
                "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.decoder.load_state_dict(sd["decoder"])
        with torch.no_grad():
            self.w_raw.copy_(sd["w_raw"])
        self.opt_model.load_state_dict(sd["opt_model"])
        self.opt_w.load_state_dict(sd["opt_w"])
        self.step = int(sd["step"])


def init_train_state(pipe: ADDvisorPipeline, decoder: str = "unet") -> AddvisorTrainState:
    """A fresh state over the pipeline's own mask decoder (trained in
    place)."""
    _check_trainable(pipe.cfg, decoder)
    model = getattr(pipe, decoder_params_key(decoder))
    w_raw = init_w_raw(pipe.cfg.loss, pipe.device)
    opt_model, opt_w = make_optimizers(pipe.cfg, model.parameters(), w_raw)
    return AddvisorTrainState(model, w_raw, opt_model, opt_w)


def make_train_step(pipe: ADDvisorPipeline, decoder: str = "unet",
                    mark: Callable[[str], None] | None = None) -> Callable:
    """-> step(state, wav, l1_scale=None) -> (state, aux dict).

    With decoder="features" the clean clip is embedded once (by the
    pipeline's own encoder: the decoder reads these features, so
    `target_gelu` does not apply), and the features serve as the decoder's
    input and, through the LogReg head, as the target.

    `wav` is [B, num_samples]. The step updates `state` in place and returns
    it with `aux`: the detached total loss, l_in, l_out, l1, `loss_vec`
    (those four on the device, for the epoch fold), the softplus weights
    after the renorm and the first clip's mask. The gradients of the step
    stay on the decoder's parameters and on `state.w_raw` until the next one.
    A profiler passes `mark`: it is called with "collate", "forward",
    "backward" and "optimiser" as each of those phases has been enqueued.

    The step runs under cuDNN's deterministic algorithms
    (`device.deterministic_cudnn`), so two identical steps on the card give
    the same losses and gradients bit for bit, as the JAX step does.
    """
    _check_trainable(pipe.cfg, decoder)
    cfg = pipe.cfg
    mark = mark or (lambda name: None)
    features = decoder_params_key(decoder) == "feat_decoder"
    # With the UNet the clean embed only produces the gradient-free target,
    # so it may take another GELU (TrainConfig.target_gelu): a second module
    # over the same weights.
    target_encoder = (pipe.encoder.with_gelu(cfg.train.target_gelu)
                      if cfg.train.target_gelu != "exact" and not features else None)

    def classify_wav(wav: torch.Tensor, encoder=None) -> torch.Tensor:
        feats = pipe.embed(wav, encoder)
        return logreg_apply(pipe.logreg, feats.mean(dim=1))[0]

    def step(state: AddvisorTrainState, wav, l1_scale=None):
        with deterministic_cudnn():
            return _step(state, wav, l1_scale)

    def _step(state: AddvisorTrainState, wav, l1_scale):
        wav = to_device(wav, pipe.device)
        with torch.no_grad():  # the collate stage: STFT and the clean target
            _, _, mag, phase = pipe.stft_stage(wav)
            if features:
                dec_in = pipe.embed(wav)
                logits = logreg_apply(pipe.logreg, dec_in.mean(dim=1))[0]
            else:
                logits = classify_wav(wav, target_encoder)
                dec_in = crop_spec(mag, cfg.unet.freq_bins, cfg.unet.frames)
            class_pred = torch.sigmoid(logits)
        mark("collate")

        state.decoder.train()
        try:
            mask = state.decoder(dec_in)
        finally:
            state.decoder.eval()
        total, losses, _ = lmac_loss(state.w_raw, mask, mag, phase, class_pred, classify_wav,
                                     pipe.istft_stage, cfg.loss, l1_scale=l1_scale)
        mark("forward")
        state.opt_model.zero_grad(set_to_none=True)
        state.opt_w.zero_grad(set_to_none=True)
        total.backward()
        mark("backward")
        state.opt_model.step()
        if cfg.train.freeze_l1_weight:
            # no gradient step on the L1 weight (TrainConfig.freeze_l1_weight)
            state.w_raw.grad[-1] = 0.0
        state.opt_w.step()
        if cfg.train.renorm_loss_w:
            with torch.no_grad():
                state.w_raw.copy_(renormalize_w(state.w_raw,
                                                freeze_last=cfg.train.freeze_l1_weight))
        state.step += 1
        mark("optimiser")

        total, losses = total.detach(), losses.detach()
        aux = {
            "loss": total, "l_in": losses[0], "l_out": losses[1], "l1": losses[2],
            "loss_vec": torch.cat([total[None], losses]),
            "w": softplus_weights(state.w_raw.detach()),
            "mask_first": mask[0].detach(),
        }
        return state, aux

    return step


def train_addvisor(
    pipe: ADDvisorPipeline,
    batches: Callable[[], Any],
    num_epochs: int | None = None,
    log_fn: Callable[[dict], None] | None = None,
    checkpoint_fn: Callable[[int, AddvisorTrainState, float], None] | None = None,
    initial_state: AddvisorTrainState | None = None,
    decoder: str = "unet",
    l1_scale: float | None = None,
    l1_warmup_epochs: int = 0,
) -> AddvisorTrainState:
    """Epoch loop. `batches()` yields wav arrays [B, num_samples] for one
    epoch. Logging and checkpointing are injected. Pass `initial_state` (a
    restored checkpoint) to resume. `l1_scale` overrides `cfg.loss.l1_scale`;
    `l1_warmup_epochs` ramps it linearly from 1.0 to `l1_scale` over that
    many epochs.

    The host stays off the hot path: batches are staged onto the device by a
    background thread that runs ahead across epoch boundaries, per-step
    losses stay on the device, and one [n, 4] fold per epoch brings them to
    the host. A probe every `cfg.train.nan_check_every` steps bounds how long
    a diverged run continues; the fold names the exact failing step."""
    cfg = pipe.cfg
    state = init_train_state(pipe, decoder) if initial_state is None else initial_state
    step_fn = make_train_step(pipe, decoder)
    num_epochs = cfg.train.num_epochs if num_epochs is None else num_epochs
    nan_every = cfg.train.nan_check_every

    def _l1_for_epoch(e: int) -> float | None:
        if l1_scale is None:
            return None
        if l1_warmup_epochs and l1_warmup_epochs > 0:
            frac = min(1.0, (e + 1) / l1_warmup_epochs)
            return 1.0 + (float(l1_scale) - 1.0) * frac
        return float(l1_scale)

    def _raise_nonfinite(epoch: int, vals: torch.Tensor) -> None:
        bad = torch.nonzero(~torch.isfinite(vals[:, 0])).flatten()
        if bad.numel():
            # halt on divergence instead of training on NaN weights; the
            # caller resumes from the last checkpoint
            raise FloatingPointError(
                f"non-finite loss at epoch {epoch + 1} step {int(bad[0])}: "
                f"{float(vals[int(bad[0]), 0])}")

    def _epoch_stream():
        for epoch in range(num_epochs):
            got = False
            for wav in batches():
                got = True
                yield epoch, to_device(wav, pipe.device)
            if not got:
                yield epoch, None  # keep the per-epoch record contract

    def _finish_epoch(epoch: int, loss_vecs: list, t0: float) -> float:
        vals = (torch.stack(loss_vecs) if loss_vecs else torch.zeros((0, 4))).cpu()
        t1 = time.perf_counter()  # the copy above waited for the device
        _raise_nonfinite(epoch, vals)
        n = max(vals.shape[0], 1)
        sums = vals.double().sum(dim=0)
        avg = float(sums[0]) / n
        if log_fn is not None:
            log_fn({
                "epoch": epoch + 1, "loss": avg, "l_in": float(sums[1]) / n,
                "l_out": float(sums[2]) / n, "l1": float(sums[3]) / n,
                "w": softplus_weights(state.w_raw.detach()).tolist(), "sec": t1 - t0,
            })
        every = cfg.train.checkpoint_every
        if checkpoint_fn is not None and every and (epoch + 1) % every == 0:
            checkpoint_fn(epoch + 1, state, avg)
        return t1

    cur_epoch, i, loss_vecs = 0, 0, []
    t0 = time.perf_counter()
    for epoch, wav in prefetch(_epoch_stream(), size=2):
        if epoch != cur_epoch:
            # epochs tile wall-clock: the next starts where this one ended
            t0 = _finish_epoch(cur_epoch, loss_vecs, t0)
            cur_epoch, i, loss_vecs = epoch, 0, []
        if wav is None:  # empty epoch placeholder
            continue
        _, aux = step_fn(state, wav, l1_scale=_l1_for_epoch(epoch))
        loss_vecs.append(aux["loss_vec"])
        if nan_every and (i + 1) % nan_every == 0 and not bool(
                torch.isfinite(aux["loss_vec"]).all()):
            _raise_nonfinite(epoch, torch.stack(loss_vecs).cpu())
        i += 1
    if num_epochs > 0:
        _finish_epoch(cur_epoch, loss_vecs, t0)
    return state


def restore_decoder_for_inference(path: str, pipe: ADDvisorPipeline,
                                  decoder: str = "unet") -> torch.nn.Module:
    """Load the mask decoder of a checkpoint (the UNet's parameters and
    BatchNorm statistics, or the feature decoder's parameters) into the
    pipeline's own and return it. Trainer checkpoints carry the full train
    state (`train/checkpoints.py`); a bare decoder state dict, with or
    without the DDP `module.` prefix, loads too."""
    key = decoder_params_key(decoder)
    sd = load_checkpoint(path, pipe.device)
    sd = sd.get("decoder", sd)
    model = getattr(pipe, key)
    if key == "unet":
        load_reference_state_dict(model, sd)
    else:
        model.load_state_dict({k.removeprefix("module."): v for k, v in sd.items()})
    return model.eval()
