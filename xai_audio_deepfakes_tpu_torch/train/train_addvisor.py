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
import torch.distributed as dist

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
from xai_audio_deepfakes_tpu_torch.models.unet import (
    load_reference_state_dict,
    set_batch_stats_group,
)
from xai_audio_deepfakes_tpu_torch.ops.masking import crop_spec
from xai_audio_deepfakes_tpu_torch.parallel.mesh import STAGE_AXIS, batch_sharding, group_size
from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline
from xai_audio_deepfakes_tpu_torch.train.checkpoints import (
    HostSnapshot,
    load_checkpoint,
    record_event,
    to_host,
)
from xai_audio_deepfakes_tpu_torch.utils.profiling import span


def decoder_params_key(decoder: str) -> str:
    """The parameter-tree key (and pipeline attribute) of the trainable mask
    decoder."""
    if decoder == "unet":
        return "unet"
    if decoder == "features":
        return "feat_decoder"
    raise ValueError(f"unknown decoder {decoder!r}")


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
    model = getattr(pipe, decoder_params_key(decoder))
    w_raw = init_w_raw(pipe.cfg.loss, pipe.device)
    opt_model, opt_w = make_optimizers(pipe.cfg, model.parameters(), w_raw)
    return AddvisorTrainState(model, w_raw, opt_model, opt_w)


def _data_mean_(tensors: list, group) -> None:
    """Average each tensor, in place, over `group` (one coalesced f32
    all-reduce); nothing with a group of one rank."""
    if group_size(group) == 1 or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= group_size(group)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


def make_train_step(pipe: ADDvisorPipeline, decoder: str = "unet",
                    mark: Callable[[str], None] | None = None, mesh=None) -> Callable:
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
    `step.forward(state, wav, l1_scale=None, train_bn=True, on_logits=None)`
    is the step's collate and forward alone, with no update.
    The four phases are the spans `train.collate`, `train.forward`,
    `train.backward` and `train.optimiser` (`utils/profiling.py`); a
    caller's `mark` is called with "collate", "forward", "backward" and
    "optimiser" as each of those phases has been enqueued.

    The step runs under cuDNN's deterministic algorithms
    (`device.deterministic_cudnn`), so two identical steps on the card give
    the same losses and gradients bit for bit, as the JAX step does.

    With `mesh` (`parallel/mesh.py`), `pipe` is the rank's view
    (`parallel/inference.py::shard_pipeline_params`) and every rank passes
    the same batch: the step takes the rank's data shard of it, the UNet's
    BatchNorm takes its statistics over the data axis, and the decoder's
    and the loss weights' gradients, then the losses of `aux`, are averaged
    over it (the loss is a mean over the batch, so the averages are the
    whole batch's). At one rank every one of these is the plain step.
    """
    cfg = pipe.cfg
    group = None if mesh is None else mesh.group(mesh.cfg.data_axis)
    if decoder_params_key(decoder) == "unet":
        set_batch_stats_group(pipe.unet, group)
    mark = mark or (lambda name: None)
    features = decoder_params_key(decoder) == "feat_decoder"
    # With the UNet the clean embed only produces the gradient-free target,
    # so it may take another GELU and int8 products (TrainConfig.target_gelu,
    # target_quant): a second module over the same weights.
    tc = cfg.train
    target_encoder = (pipe.encoder.with_config(tc.target_gelu, tc.target_quant)
                      if (tc.target_gelu != "exact" or tc.target_quant != "none")
                      and not features else None)

    def classify_wav(wav: torch.Tensor, encoder=None) -> torch.Tensor:
        feats = pipe.embed(wav, encoder)
        return logreg_apply(pipe.logreg, feats.mean(dim=1))[0]

    def step(state: AddvisorTrainState, wav, l1_scale=None):
        with deterministic_cudnn():
            return _step(state, wav, l1_scale)

    def forward(state: AddvisorTrainState, wav, l1_scale=None, train_bn: bool = True,
                on_logits: Callable[[torch.Tensor], None] | None = None):
        """The step's collate and forward: -> (total, losses [3], mask).
        `train_bn=False` runs the decoder's BatchNorm on its running
        statistics; `on_logits` is called with the detector's logits of the
        relevant, then of the irrelevant waveform."""
        classify = classify_wav
        if on_logits is not None:
            def classify(w, encoder=None):
                logits = classify_wav(w, encoder)
                on_logits(logits)
                return logits

        with span("train.collate"):
            wav = to_device(wav, pipe.device)
            if mesh is not None:
                wav = batch_sharding(mesh, wav)
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

        with span("train.forward"):
            state.decoder.train(train_bn)
            try:
                mask = state.decoder(dec_in)
            finally:
                state.decoder.eval()
            total, losses, _ = lmac_loss(state.w_raw, mask, mag, phase, class_pred, classify,
                                         pipe.istft_stage, cfg.loss, l1_scale=l1_scale)
        mark("forward")
        return total, losses, mask

    def _step(state: AddvisorTrainState, wav, l1_scale):
        total, losses, mask = forward(state, wav, l1_scale)
        with span("train.backward"):
            state.opt_model.zero_grad(set_to_none=True)
            state.opt_w.zero_grad(set_to_none=True)
            total.backward()
            _data_mean_([p.grad for p in state.decoder.parameters() if p.grad is not None]
                        + [state.w_raw.grad], group)
        mark("backward")
        with span("train.optimiser"):
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
        if group_size(group) > 1:
            vec = torch.cat([total[None], losses])
            _data_mean_([vec], group)
            total, losses = vec[0], vec[1:]
        aux = {
            "loss": total, "l_in": losses[0], "l_out": losses[1], "l1": losses[2],
            "loss_vec": torch.cat([total[None], losses]),
            "w": softplus_weights(state.w_raw.detach()),
            "mask_first": mask[0].detach(),
        }
        return state, aux

    step.forward = forward
    return step


def train_addvisor(
    pipe: ADDvisorPipeline,
    batches: Callable[[], Any],
    num_epochs: int | None = None,
    log_fn: Callable[[dict], None] | None = None,
    artifact_fn: Callable[[int, torch.Tensor, dict], None] | None = None,
    checkpoint_fn: Callable[[int, Any, float], None] | None = None,
    initial_state: AddvisorTrainState | None = None,
    decoder: str = "unet",
    l1_scale: float | None = None,
    l1_warmup_epochs: int = 0,
    mesh=None,
) -> AddvisorTrainState:
    """Epoch loop. `batches()` yields wav arrays [B, num_samples] for one
    epoch. Logging, artifacts and checkpointing are injected:
    `artifact_fn(epoch, mask, aux)` gets each epoch's first step's first
    mask (on the device) and that step's aux; `checkpoint_fn(epoch, state,
    loss)` gets, every `cfg.train.checkpoint_every` epochs, a
    `checkpoints.HostSnapshot` of the state at that epoch's end (it has
    `state_dict()` and `step`; `save_checkpoint` writes it with no second
    copy). Pass `initial_state` (a restored checkpoint)
    to resume. `l1_scale` overrides `cfg.loss.l1_scale`;
    `l1_warmup_epochs` ramps it linearly from 1.0 to `l1_scale` over that
    many epochs.

    With `mesh` (`parallel/mesh.py::make_mesh`; every rank runs this loop
    with the same batches) the frozen embedder is sharded as its specs say
    (`parallel/inference.py::shard_pipeline_params`: Megatron over the model
    axis, the layer stack over the stage axis, which needs `scan_layers`),
    each step runs on the rank's data shard and the decoder's gradients are
    averaged over the data axis (`make_train_step`). The decoder stays the
    pipeline's own, trained in place on every rank.

    The host stays off the hot path: batches are staged onto the device by a
    background thread that runs ahead across epoch boundaries, per-step
    losses stay on the device, and each epoch's [n, 4] fold is copied to the
    host asynchronously and finalised (record, `log_fn`, `checkpoint_fn`)
    one epoch late, so the host never waits for the device at a boundary.
    The last epoch drains: its `sec` covers the real compute, where an
    earlier epoch's covers the host's time between its boundaries. A probe
    every `cfg.train.nan_check_every` steps bounds how long a diverged run
    continues; the fold names the exact failing step."""
    cfg = pipe.cfg
    if mesh is not None:
        from xai_audio_deepfakes_tpu_torch.parallel.inference import shard_pipeline_params

        if mesh.size(STAGE_AXIS) > 1 and not cfg.embedder.scan_layers:
            raise ValueError("pipeline-parallel training needs scan_layers=True "
                             "(stacked [L, ...] layer params)")
        pipe = shard_pipeline_params(pipe, mesh)
    state = init_train_state(pipe, decoder) if initial_state is None else initial_state
    step_fn = make_train_step(pipe, decoder, mesh=mesh)
    num_epochs = cfg.train.num_epochs if num_epochs is None else num_epochs
    nan_every = cfg.train.nan_check_every
    every = cfg.train.checkpoint_every

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

    def _finish_epoch(epoch: int, loss_vecs: list, t0: float, drain: bool = False):
        """Stage the epoch's fold: its losses and loss weights start their
        copy to the host now (in stream order, before the next epoch's
        steps), and on checkpoint epochs the state its snapshot; `_finalize`
        reads them one boundary later. With `drain` (the last epoch) the
        host waits for the device first, so that `sec` covers the compute."""
        dev = state.w_raw.device
        vec = torch.stack(loss_vecs) if loss_vecs else torch.zeros((0, 4), device=dev)
        w = softplus_weights(state.w_raw.detach())
        snap = HostSnapshot(state) if checkpoint_due(epoch) else None
        if drain:
            vec, w, ready = vec.cpu(), w.cpu(), None
        else:
            vec, w = to_host(vec, non_blocking=True), to_host(w, non_blocking=True)
            ready = record_event(dev)
        return epoch, vec, w, snap, ready, t0, time.perf_counter()

    def checkpoint_due(epoch: int) -> bool:
        return checkpoint_fn is not None and bool(every) and (epoch + 1) % every == 0

    def _finalize(staged) -> None:
        epoch, vals, w, snap, ready, t0, t1 = staged
        if ready is not None:
            ready.synchronize()
        _raise_nonfinite(epoch, vals)
        n = max(vals.shape[0], 1)
        sums = vals.double().sum(dim=0)
        avg = float(sums[0]) / n
        if log_fn is not None:
            log_fn({
                "epoch": epoch + 1, "loss": avg, "l_in": float(sums[1]) / n,
                "l_out": float(sums[2]) / n, "l1": float(sums[3]) / n,
                "w": w.tolist(), "sec": t1 - t0,
            })
        if snap is not None:
            checkpoint_fn(epoch + 1, snap, avg)

    cur_epoch, i, loss_vecs, staged_prev = 0, 0, [], None
    t0 = time.perf_counter()
    for epoch, wav in prefetch(_epoch_stream(), size=2):
        if epoch != cur_epoch:
            staged = _finish_epoch(cur_epoch, loss_vecs, t0)
            if staged_prev is not None:
                _finalize(staged_prev)
            staged_prev = staged
            cur_epoch, i, loss_vecs = epoch, 0, []
            # epochs tile wall-clock: the next starts where this one was staged
            t0 = staged[-1]
        if wav is None:  # empty epoch placeholder
            continue
        _, aux = step_fn(state, wav, l1_scale=_l1_for_epoch(epoch))
        if i == 0 and artifact_fn is not None:
            artifact_fn(epoch, aux["mask_first"], aux)
        loss_vecs.append(aux["loss_vec"])
        if nan_every and (i + 1) % nan_every == 0 and not bool(
                torch.isfinite(aux["loss_vec"]).all()):
            _raise_nonfinite(epoch, torch.stack(loss_vecs).cpu())
        i += 1
    if num_epochs > 0:
        staged = _finish_epoch(cur_epoch, loss_vecs, t0, drain=True)
        if staged_prev is not None:
            _finalize(staged_prev)
        _finalize(staged)
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
