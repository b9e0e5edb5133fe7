"""Batched evaluation harnesses (port of `metrics/harness.py`).

  * run_explanation_metrics: per batch the explain path (clean, relevant
    and irrelevant probabilities), folded into faithfulness / fidelity / AD
    / AI / AG;
  * run_attribution_metrics: per batch a waveform-domain attribution mask,
    the relevant and irrelevant waveforms and three `classify` calls,
    folded into faithfulness, fidelity and the count of relevant clips
    classified manipulated (over all clips, under the configured polarity).

Each batch reduces to a few sums on the device; the sums come to the host
once, after the last batch, and fold there in float64, so eval memory is
O(1) in clips and the host does not wait for the device between batches.

The attribution gradients take cuDNN's deterministic algorithms
(`device.deterministic_cudnn`): with its default ones the backward
convolutions of the embedder may sum in any order, so two runs on the same
weights and clips gave different maps, and masks near a threshold then
flipped the sweep's decisions.

Attribution runs through every embedder configuration, int8 included: the
int8 products take integer operands and have no gradient of their own, and
`torch.round` has a zero gradient, so, as in the JAX package, the gradient
flows through the residual stream, the float layers and the dynamic
scales' `amax`.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from xai_audio_deepfakes_tpu_torch.attrib.methods import waveform_explanation
from xai_audio_deepfakes_tpu_torch.config import MaskingConvention, manipulated_probability
from xai_audio_deepfakes_tpu_torch.device import deterministic_cudnn
from xai_audio_deepfakes_tpu_torch.metrics.lmac_metrics import (
    compute_faithfulness,
    compute_fidelity,
    merge_summaries,
    summarize_sums,
)
from xai_audio_deepfakes_tpu_torch.models.logreg import logreg_apply
from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline


def run_explanation_metrics(
    pipe: ADDvisorPipeline,
    batches: Iterable,
    decoder: str = "unet",
    masking: MaskingConvention = MaskingConvention.LOG1P,
    log_fn: Callable[[dict], None] | None = None,
    mesh=None,
) -> dict:
    """The LMAC faithfulness sweep over `batches` (wav arrays [B, L]) ->
    the `merge_summaries` dict. With `mesh` (`parallel/mesh.py::make_mesh`)
    the sweep runs sharded (`parallel/inference.py::make_sharded_explain`):
    every rank passes the same batches, explains its data shard, and folds
    the gathered probabilities; batch sizes must divide by the data axis's
    size."""
    if mesh is not None:
        from xai_audio_deepfakes_tpu_torch.parallel.inference import make_sharded_explain

        explain, _ = make_sharded_explain(pipe, mesh, decoder=decoder, masking=masking)
    else:
        def explain(wav):
            return pipe.explain(wav, decoder=decoder, masking=masking)
    partials = []
    with torch.inference_mode():
        for wav in batches:
            out = explain(wav)
            partials.append(summarize_sums(out.probs_clean, out.probs_relevant,
                                           out.probs_irrelevant))
    result = merge_summaries(partials)
    if log_fn is not None:
        log_fn({"explanation_metrics": result})
    return result


def run_attribution_metrics(
    pipe: ADDvisorPipeline,
    batches: Iterable,
    method: str = "input_x_gradient",
    log_fn: Callable[[dict], None] | None = None,
    artifact_fn: Callable[..., None] | None = None,
    **method_kw,
) -> dict:
    """The attribution baseline sweep. The score is the detector's logit
    through the pipeline's grad-carrying `embed` and the LogReg head;
    `method_kw` goes to `waveform_explanation` (a `generator` for the random
    methods among it). The gradients are reproducible on the card
    (`deterministic_cudnn`). With `artifact_fn`, each batch's waveform mask and
    relevant / irrelevant waveforms also come to the host, as
    artifact_fn(wav, mask, rel_wav, irr_wav, p_clean, p_rel, p_irr) of
    numpy arrays."""

    def score_fn(w: torch.Tensor) -> torch.Tensor:
        return logreg_apply(pipe.logreg, pipe.embed(w).mean(dim=1))[0]

    sums, n_clips = [], 0
    for wav in batches:
        wav = pipe._as_input(wav)
        with deterministic_cudnn():
            mask, rel, irr = waveform_explanation(score_fn, wav, method=method, **method_kw)
        with torch.inference_mode():
            _, p_clean = pipe.classify(wav)
            _, p_rel = pipe.classify(rel)
            _, p_irr = pipe.classify(irr)
            manipulated = manipulated_probability(p_rel[:, 0], pipe.cfg.polarity) >= 0.5
            sums.append(torch.stack([compute_faithfulness(p_clean, p_irr).sum(),
                                     compute_fidelity(p_rel, p_clean).sum(),
                                     manipulated.float().sum()]))
        if artifact_fn is not None:
            artifact_fn(*(t.detach().cpu().numpy()
                          for t in (wav, mask, rel, irr, p_clean, p_rel, p_irr)))
        n_clips += wav.shape[0]
    total = (torch.stack(sums).cpu().double().sum(dim=0) if sums
             else torch.zeros(3, dtype=torch.float64))
    denom = max(n_clips, 1)
    result = {
        "method": method,
        "faithfulness": float(total[0]) / denom,
        "fidelity": float(total[1]) / denom,
        "relevant_classified_manipulated": int(total[2]),
        "num_clips": n_clips,
    }
    if log_fn is not None:
        log_fn({"attribution_metrics": result})
    return result
