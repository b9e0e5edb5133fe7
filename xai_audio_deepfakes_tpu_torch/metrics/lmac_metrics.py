"""Faithfulness metrics for mask explanations (port of
`metrics/lmac_metrics.py`).

Torch functions over probability tensors [N, 1] (or [N]), on any device.
Every metric is a per-clip mean, so a sweep folds as (sum, count) partials:
`summarize_sums` gives one batch's partial on the device, `merge_summaries`
folds the partials on the host.

  score for the predicted class: p if p > 0.5 else 1 - p
  fidelity: 1 where the masked and clean decisions (p > 0.5) agree
  faithfulness FF = (p - p_masked) * sign(p - 0.5)
  AD = relu(pc - oc) / (pc + eps) * 100, AI = 100 * [oc > pc],
  AG = relu(oc - pc) / (1 - pc + eps) * 100, eps = 1e-10
"""

from __future__ import annotations

import torch

EPS = 1e-10

METRIC_KEYS = ("faithfulness", "fidelity", "average_drop", "average_increase",
               "average_gain")


def _squeeze(p: torch.Tensor) -> torch.Tensor:
    return p[..., 0] if p.ndim > 1 else p


def compute_fidelity(theta_out: torch.Tensor, predictions: torch.Tensor,
                     threshold: float = 0.5) -> torch.Tensor:
    """1.0 where the masked and clean predictions agree on the decision."""
    return ((_squeeze(predictions) > threshold) == (_squeeze(theta_out) > threshold)).float()


def get_score_for_predicted_class(p: torch.Tensor) -> torch.Tensor:
    pred = (p > 0.5).to(p.dtype)
    return pred * p + (1.0 - pred) * (1.0 - p)


def compute_faithfulness(predictions: torch.Tensor,
                         predictions_masked: torch.Tensor) -> torch.Tensor:
    p = _squeeze(predictions)
    return (p - _squeeze(predictions_masked)) * torch.sign(p - 0.5)


def _scores(theta_out, predictions):
    return (get_score_for_predicted_class(_squeeze(predictions)),
            get_score_for_predicted_class(_squeeze(theta_out)))


def compute_AD(theta_out: torch.Tensor, predictions: torch.Tensor) -> torch.Tensor:
    pc, oc = _scores(theta_out, predictions)
    return torch.clamp(pc - oc, min=0.0) / (pc + EPS) * 100.0


def compute_AI(theta_out: torch.Tensor, predictions: torch.Tensor) -> torch.Tensor:
    pc, oc = _scores(theta_out, predictions)
    return (oc > pc).float() * 100.0


def compute_AG(theta_out: torch.Tensor, predictions: torch.Tensor) -> torch.Tensor:
    pc, oc = _scores(theta_out, predictions)
    return torch.clamp(oc - pc, min=0.0) / (1.0 - pc + EPS) * 100.0


def _per_clip(predictions, theta_out, masked_predictions) -> list[torch.Tensor]:
    """The five per-clip metrics in METRIC_KEYS order. predictions: clean
    probabilities; theta_out: relevant-masked; masked_predictions:
    irrelevant-masked."""
    return [compute_faithfulness(predictions, masked_predictions),
            compute_fidelity(theta_out, predictions),
            compute_AD(theta_out, predictions),
            compute_AI(theta_out, predictions),
            compute_AG(theta_out, predictions)]


def summarize(predictions: torch.Tensor, theta_out: torch.Tensor,
              masked_predictions: torch.Tensor) -> dict:
    """The aggregate of one set of clips: {metric: mean} as 0-d tensors."""
    return {k: v.mean() for k, v in
            zip(METRIC_KEYS, _per_clip(predictions, theta_out, masked_predictions))}


def summarize_sums(predictions: torch.Tensor, theta_out: torch.Tensor,
                   masked_predictions: torch.Tensor) -> tuple[torch.Tensor, int]:
    """One batch's partial: (sums [5] in METRIC_KEYS order, on the device;
    the clip count). Fold partials with `merge_summaries`. The per-clip
    metrics are taken in f64 from the f32 probabilities: near 0 or 1, the
    f32 `1 - pc` and `oc - pc` keep few digits (AG of probabilities near
    0.004 lost 7.5e-5 of itself), and the fold is in f64 anyway."""
    sums = torch.stack([v.sum() for v in _per_clip(
        *(t.double() for t in (predictions, theta_out, masked_predictions)))])
    return sums, int(_squeeze(predictions).shape[0])


def merge_summaries(partials) -> dict:
    """[(sums, count), ...] -> the `summarize` dict of floats + num_clips.
    The partials come to the host in one transfer and are folded there in
    float64."""
    partials = list(partials)
    if not partials:
        raise ValueError(
            "no batches to summarize: the eval produced zero metric partials "
            "(all clips dropped by batching, or empty metadata)")
    total = sum(int(c) for _, c in partials)
    acc = torch.stack([torch.as_tensor(s).cpu() for s, _ in partials]).double().sum(dim=0)
    out = {k: float(v) / max(total, 1) for k, v in zip(METRIC_KEYS, acc)}
    out["num_clips"] = total
    return out
