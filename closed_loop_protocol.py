#!/usr/bin/env python3
"""Run the anyband closed-loop protocol with the PyTorch/CUDA port on one
NVIDIA card and print its result.

    python3 closed_loop_protocol.py [--seed 0] [--f32-embedder] [--reference-draw]
        [--l1-scale X] [--save-decoder PATH] [--probe] [--head-probe]
        [--bf16-operand-fit] [--out PATH]

The protocol is the command line behind the JAX package's
`docs/closed_loop_anyband` result (`cli closed-loop --anyband --scan-layers
--remat --remat-policy dots --dtype bfloat16 --batch-size 16 --n-train 128
--n-eval 64 --epochs 120`, its noise rms 1.0 and decoder lr 3e-4), in
`closed_loop.anyband_protocol_config()`: a band-swap corpus whose artifact
band is drawn per clip, the LogReg detector fitted on its embeddings, the
UNet mask decoder trained against that detector, and the masks scored
against each clip's band. The weights are random, from the seed; the sizes
are fixed (the CLI's `closed-loop` will take them as options).
`--f32-embedder` runs the control: the same protocol with the embedder in
f32 and remat off (`scan_layers` is a parameter layout and stays), which
takes the bf16 and "dots" gradient path out of the loop.

`--reference-draw` loads the JAX package's own weights for the seed,
`init_params(PRNGKey(seed))` replayed by `reference_draw.py`, in place of
the port's torch draw; at seed 0 these are the weights behind
`docs/closed_loop_anyband` (and, with `--l1-scale 4`,
`docs/closed_loop_anyband_l1x4`). There it prints a witness after epoch 1
(`loss`, `l_in`, `l_out`, `l1`, `w`) beside the record's, and the result
holds the detector's accuracy and EER on its split and held out, every
epoch, and the untrained decoder's per-clip localisation (which depends on
the UNet's weights and the evaluation clips alone) beside the record's.
`--l1-scale` multiplies the L1 term (`cli closed-loop --l1-scale`).
`--save-decoder` writes the trained UNet's state dict (weights and running
statistics). `--probe` measures, on the 64 training clips that `after_train`
explains, p(manipulated) of the complement and the flip rate four ways:
(i) the explain (BatchNorm on its running statistics), (ii) the explain
with BatchNorm on each batch of 16's own statistics, (iii) the training
step's own collate and forward (`make_train_step(...).forward`, BatchNorm
in training mode, as the step runs it), (iv) that forward with BatchNorm on
its running statistics; and, per BatchNorm layer, the relative gap between
the running statistics and the mean of the last epoch's batch statistics.
The running statistics are restored after (ii) and (iii).

`--head-probe` (with `--reference-draw`) stops after epoch 1 and measures
how far epoch 1's `l_out` follows the detector head (`head_probe`): the
detector corpus and the evaluation clips embedded four ways the protocol's
embedder could legitimately take (bf16 at batches 16, 8 and 24, and the f32
embedder at 16), each set fitted by the port's `train_detector`, and epoch 1
run from the same untrained decoder with each head; a fifth way,
`bf16_operands_batch16`, fits the protocol's own embeddings with
`train_detector_bf16_operands` and runs epoch 1 with that head as fitted and
again with its weight rounded to bf16. Per head it prints the
embeddings' distance from the protocol's own, |w|, the median |logit|, the
L-BFGS steps and the distance to the float64 optimum, the cosine to the
protocol's head, the split and held-out accuracy and EER, and epoch 1's
`loss`, `l_in`, `l_out` (over the record's at seed 0), `l1` and `w`; last,
the largest `l_out` over the smallest among the four f32 fits.

`--bf16-operand-fit` runs the protocol with the detector fitted as a v5e
fits it at JAX's default matmul precision: `bf16_operand_objective`, the
port's objective with both operands of the logit's product, and of its
gradient's, rounded to bf16 and summed in f32 (`round_bf16`,
`Bf16OperandProduct`), through the port's `lbfgs_fit` with the same split,
stopping rule and evaluation (`train_detector_bf16_operands`). The
package's own fit is not touched. This reproduces a TPU's arithmetic; it
is a diagnostic, not an option of the system.

It prints the card's name and power limit, each epoch's record as it is
finalised, and last one JSON line: the detector's accuracy and EER, its
fit (corpus rows and features, training rows, L-BFGS steps and seconds,
|w| and the median |logit| on its training rows), the before / after /
after-train localisation, keep and flip rates and LMAC
metrics, the steady epoch seconds and clips/s through the epoch loop, and
the phases' seconds (with `--reference-draw`, the replay and the load of its
weights apart; `wall_s` counts neither, as before they existed: the
pipeline's build and `run_closed_loop`). `--out` also writes that JSON and
the training log.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

N_TRAIN, N_EVAL, EPOCHS, BATCH_SIZE, NOISE_RMS = 128, 64, 120, 16, 1.0
ROOT = Path(__file__).resolve().parent
# the JAX package's seed-0 records, by L1 scale, and the witness's bars
# (TPU bf16 against H100 bf16: no bit equality): the detector's accuracy
# and EER within 0.02, epoch 1's l_out within 10% and l1 within 5%
RECORDS = {1.0: "docs/closed_loop_anyband", 4.0: "docs/closed_loop_anyband_l1x4"}
DET_TOL, L_OUT_REL, L1_REL = 0.02, 0.10, 0.05


def load_record(l1_scale: float | None) -> tuple[dict, list] | None:
    """(the record's result, its epoch records) for this L1 scale, if any."""
    d = RECORDS.get(1.0 if l1_scale is None else float(l1_scale))
    if d is None:
        return None
    res = json.loads((ROOT / d / "closed_loop.json").read_text())
    log = [json.loads(line) for line in (ROOT / d / "closed_loop_log.jsonl").read_text().split("\n")
           if line.strip()]
    return res, [r for r in log if "epoch" in r]


def detector_witness(record: dict, split: dict, held_out: dict) -> dict:
    out = {}
    for name, mine, theirs in (("split", split, record["detector"]),
                               ("held_out", held_out, record["detector_holdout"])):
        for k in ("accuracy", "eer"):
            out[f"{name}_{k}"] = {"port": mine[k], "record": theirs[k],
                                  "holds": abs(mine[k] - theirs[k]) <= DET_TOL}
    return out


def epoch_witness(rec: dict, theirs: dict) -> dict:
    out = {k: {"port": rec[k], "record": theirs[k]} for k in ("loss", "l_in", "l_out", "l1", "w")}
    out["l_out"]["holds"] = abs(rec["l_out"] / theirs["l_out"] - 1.0) <= L_OUT_REL
    out["l1"]["holds"] = abs(rec["l1"] / theirs["l1"] - 1.0) <= L1_REL
    return out


def untrained_witness(mine: list, theirs: list) -> dict:
    """The untrained decoder's per-clip localisation against the record's:
    it depends on the UNet's weights and the evaluation clips only (not on
    the detector), so it witnesses the replayed UNet and the corpus."""
    return {k: max(abs(a[k] - b[k]) for a, b in zip(mine, theirs))
            for k in ("iou", "in_band_mean", "out_band_mean")}


def against_record(records: list, theirs: list) -> dict:
    """Per epoch, the port's l_out, l1 and w over the record's, and the
    first epoch where one leaves the witness's bars (w by 5%)."""
    ratio = {k: [] for k in ("l_out", "l1", "w_max_rel")}
    first = None
    for mine, rec in zip(records, theirs):
        r_out, r_l1 = mine["l_out"] / rec["l_out"], mine["l1"] / rec["l1"]
        w_rel = max(abs(a / b - 1.0) for a, b in zip(mine["w"], rec["w"]))
        ratio["l_out"].append(r_out)
        ratio["l1"].append(r_l1)
        ratio["w_max_rel"].append(w_rel)
        if first is None and (abs(r_out - 1) > L_OUT_REL or abs(r_l1 - 1) > L1_REL
                              or w_rel > L1_REL):
            first = mine["epoch"]
    return {"first_epoch_beyond_bars": first, **ratio}


def bn_layers(unet) -> dict:
    from xai_audio_deepfakes_tpu_torch.models.unet import BatchNorm2d

    return {name: m for name, m in unet.named_modules() if isinstance(m, BatchNorm2d)}


def record_batch_stats(torch, unet, keep: int) -> dict:
    """Forward hooks that keep, per BatchNorm layer, the last `keep`
    training-mode batches' (mean, biased var) in float64."""
    from collections import deque

    kept: dict = {}
    for name, m in bn_layers(unet).items():
        kept[name] = deque(maxlen=keep)

        def hook(mod, inp, out, q=kept[name]):
            if mod.training:
                x = inp[0].detach().double()
                mean = x.mean(dim=(0, 2, 3))
                q.append((mean, (x * x).mean(dim=(0, 2, 3)) - mean * mean))

        m.register_forward_hook(hook)
    return kept


def bn_gaps(torch, unet, kept: dict) -> dict:
    """Per layer: ||running - batch|| / ||batch|| for mean and var, the
    batch statistics averaged over the kept batches."""
    out = {}
    for name, m in bn_layers(unet).items():
        bm = torch.stack([a for a, _ in kept[name]]).mean(dim=0)
        bv = torch.stack([b for _, b in kept[name]]).mean(dim=0)
        out[name] = {
            "mean_rel": float((m.running_mean.double() - bm).norm() / bm.norm()),
            "var_rel": float((m.running_var.double() - bv).norm() / bv.norm()),
            "mean_gap_in_std": float(((m.running_mean.double() - bm).abs()
                                      / bv.clamp_min(1e-30).sqrt()).max())}
    return out


def probe(torch, pipe, state, clips, batch_size: int) -> dict:
    """p(manipulated) of the complement (mean) and the flip rate on
    `clips`, four ways (see the module's docstring)."""

    from xai_audio_deepfakes_tpu_torch.config import manipulated_probability
    from xai_audio_deepfakes_tpu_torch.device import deterministic_cudnn
    from xai_audio_deepfakes_tpu_torch.train.closed_loop import _batches
    from xai_audio_deepfakes_tpu_torch.train.train_addvisor import make_train_step

    cfg, unet = pipe.cfg, pipe.unet
    bns = list(bn_layers(unet).values())
    forward = make_train_step(pipe).forward
    l_outs: list = []

    def explain_irr(chunk, train_bn):
        unet.train(train_bn)
        try:
            return pipe.explain(chunk, masking=cfg.loss.masking).probs_irrelevant[:, 0]
        finally:
            unet.eval()

    def step_irr(chunk, train_bn):
        logits: list = []  # the relevant waveform's, then the irrelevant one's
        with torch.no_grad(), deterministic_cudnn():
            _, losses, _ = forward(state, chunk, train_bn=train_bn, on_logits=logits.append)
        l_outs.append(float(losses[1]))
        return torch.sigmoid(logits[1][:, 0])

    out = {}
    for name, fn, train_bn in (("i_explain_bn_eval", explain_irr, False),
                               ("ii_explain_bn_batch", explain_irr, True),
                               ("iii_step_bn_train", step_irr, True),
                               ("iv_step_bn_eval", step_irr, False)):
        saved = [(b.running_mean.clone(), b.running_var.clone(), b.num_batches_tracked.clone())
                 for b in bns]
        l_outs.clear()
        try:
            probs = [fn(chunk, train_bn)[:k].float().cpu()
                     for chunk, k in _batches(clips, batch_size)]
        finally:
            with torch.no_grad():
                for b, (rm, rv, nb) in zip(bns, saved):
                    b.running_mean.copy_(rm)
                    b.running_var.copy_(rv)
                    b.num_batches_tracked.copy_(nb)
        p = manipulated_probability(torch.cat(probs), cfg.polarity).numpy()
        out[name] = {"p_irr_mean": float(p.mean()), "flip_rate": float(np.mean(p < 0.5))}
        if l_outs:
            out[name]["l_out_mean_over_batches"] = float(np.mean(l_outs))
    return out


def float64_fit(torch, x, y, max_iter: int, device="cuda"):
    """The detector's objective on (x, y) fitted in float64 by the port's
    L-BFGS (tol 1e-12), to see how far an f32 fit is from the optimum.
    -> (steps, last gradient norm, weights [D], bias, the objective at any
    (w, b) in float64)."""

    from xai_audio_deepfakes_tpu_torch.train import train_logreg

    f64 = dict(dtype=torch.float64, device=device)
    xt = torch.as_tensor(x, **f64)
    yt = torch.as_tensor(y, **f64)[:, None]
    ref = {"weight": torch.zeros((x.shape[1], 1), **f64, requires_grad=True),
           "bias": torch.zeros((1,), **f64, requires_grad=True)}
    steps, _, _, gnorm = train_logreg.lbfgs_fit(
        lambda: train_logreg.logreg_objective(ref, xt, yt, 1e6), ref, max_iter, 1e-12)

    def objective(w, b) -> float:
        p = {"weight": torch.as_tensor(np.asarray(w, np.float64)[:, None], **f64),
             "bias": torch.tensor([float(b)], **f64)}
        with torch.no_grad():
            return float(train_logreg.logreg_objective(p, xt, yt, 1e6))

    return (steps, gnorm, ref["weight"].detach().cpu().numpy()[:, 0], float(ref["bias"][0]),
            objective)


def fit_summary(torch, x, y, params: dict) -> dict:
    """A fitted detector head on its corpus (x, y): the rows, features and
    training rows of its split, |w|, the median |logit| on the training
    rows, and its distance to the same objective fitted in float64."""

    from xai_audio_deepfakes_tpu_torch.train import train_logreg

    x_tr, _, y_tr, _ = train_logreg.stratified_split(x, y)
    w = params["weight"].cpu().numpy()[:, 0].astype(np.float64)
    b = float(params["bias"].cpu()[0])
    z = x_tr.astype(np.float64) @ w + b
    t0 = time.perf_counter()
    steps, gnorm, w64, b64, objective = float64_fit(torch, x_tr, y_tr, 5000,
                                                    params["weight"].device)
    best = objective(w64, b64)
    return {"rows": int(x.shape[0]), "features": int(x.shape[1]), "train_rows": int(len(x_tr)),
            "w_norm": float(np.linalg.norm(w)),
            "median_abs_logit_train": float(np.median(np.abs(z))),
            "float64_reference": {
                "steps": steps, "gnorm": gnorm, "seconds": time.perf_counter() - t0,
                "objective": best, "fit_objective_rel": (objective(w, b) - best) / best,
                "w_norm": float(np.linalg.norm(w64)),
                "cosine": float(w @ w64 / (np.linalg.norm(w) * np.linalg.norm(w64)))}}


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """An f32 tensor rounded to the nearest bf16 (ties to even), as f32: the
    operand rounding of a TPU's default matmul precision. A NaN becomes the
    quiet NaN of its sign, as XLA's f32 -> bf16 conversion makes it."""
    r = t.to(torch.bfloat16).float()
    return torch.where(torch.isnan(t), torch.full_like(t, float("nan")).copysign(t), r)


class Bf16OperandProduct(torch.autograd.Function):
    """x [N, D] @ w [D, 1] with both operands rounded to bf16 and the
    products summed in f32, as a TPU computes an f32 `dot` at default
    precision; the weight's gradient is that transposed product with bf16
    operands too, round(x)^T @ round(g). (Autograd through the casts would
    round the gradient itself to bf16.) x takes no gradient."""

    @staticmethod
    def forward(ctx, x, w):
        xr = round_bf16(x)
        ctx.save_for_backward(xr)
        return xr @ round_bf16(w)

    @staticmethod
    def backward(ctx, g):
        (xr,) = ctx.saved_tensors
        return None, xr.t() @ round_bf16(g)


def bf16_operand_objective(params: dict, x: torch.Tensor, y: torch.Tensor,
                           c: float) -> torch.Tensor:
    """`train_logreg.logreg_objective` with the logit's product at a TPU's
    default precision (`Bf16OperandProduct`): z = round(x) @ round(w) + b;
    the bias and the L2 term stay f32."""
    z = Bf16OperandProduct.apply(x, params["weight"]) + params["bias"]
    nll = (y * F.softplus(-z) + (1.0 - y) * F.softplus(z)).sum()
    return nll + 0.5 / c * (params["weight"] ** 2).sum()


def fit_bf16_operands(x, y, c: float = 1e6, max_iter: int = 1000, tol: float = 1e-7,
                      device="cuda", log_fn=None) -> dict:
    """`train_logreg.fit_logreg` on `bf16_operand_objective`: the same
    start, `lbfgs_fit`, stopping rule and log."""
    from xai_audio_deepfakes_tpu_torch.train import train_logreg

    xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
    yt = torch.as_tensor(np.asarray(y, np.float32), device=device)[:, None]
    params = {"weight": torch.zeros((x.shape[1], 1), device=device, requires_grad=True),
              "bias": torch.zeros((1,), device=device, requires_grad=True)}
    steps, evaluations, value, gnorm = train_logreg.lbfgs_fit(
        lambda: bf16_operand_objective(params, xt, yt, c), params, max_iter, tol)
    if log_fn is not None:
        log_fn({"lbfgs": {"steps": steps, "evaluations": evaluations, "objective": value,
                          "gnorm": gnorm}})
    return {k: v.detach() for k, v in params.items()}


def train_detector_bf16_operands(x, y, c: float = 1e6, test_size: float = 0.2, seed: int = 42,
                                 log_fn=None, device="cuda") -> tuple[dict, dict]:
    """`train_logreg.train_detector` with the fit of `fit_bf16_operands`:
    the same split and evaluation -> (params, metrics)."""
    from xai_audio_deepfakes_tpu_torch.train import train_logreg

    x_tr, x_te, y_tr, y_te = train_logreg.stratified_split(x, y, test_size, seed)
    params = fit_bf16_operands(x_tr, y_tr, c=c, device=device, log_fn=log_fn)
    metrics = train_logreg.evaluate_logreg(params, x_te, y_te)
    if log_fn is not None:
        log_fn({"detector": metrics})
    return params, metrics


# the head probe's ways to embed the detector corpus and fit its head: (name,
# embedder dtype, batch, fit: "f32", the port's `train_detector`, or
# "bf16_operands", `train_detector_bf16_operands`); the first is the protocol's own
PROBE_WAYS = (("bf16_batch16", "bfloat16", BATCH_SIZE, "f32"),
              ("bf16_batch8", "bfloat16", 8, "f32"),
              ("bf16_batch24", "bfloat16", 24, "f32"),
              ("f32_batch16", "float32", BATCH_SIZE, "f32"),
              ("bf16_operands_batch16", "bfloat16", BATCH_SIZE, "bf16_operands"))


def head_probe(torch, pipes: dict, seed: int, record_l_out: float | None) -> dict:
    """How far epoch 1's `l_out` follows the detector head. The protocol's
    first stages as `run_closed_loop` takes them (the same rng draws: the
    training and evaluation corpora, the detector corpus, then the first
    epoch's shuffle), with the detector corpus and the evaluation clips
    embedded each way of `PROBE_WAYS` (`pipes` maps an embedder dtype to a
    pipeline holding the same weights), each set fitted by the port's
    `train_detector`, and epoch 1 (one `train_addvisor` epoch, batches of
    16) run from the same untrained decoder with each head on the bf16
    pipeline. Ways whose embeddings are bit-equal to an earlier way's of the
    same fit are named and not fitted again. The "bf16_operands" way runs
    epoch 1 a second time with its head's weight rounded to bf16, as the
    v5e's step takes that product at default precision. The mean-pooled
    features, its other operand, stay f32: rounding them is one bf16 step
    on each of 1920 independent terms, whose errors add in quadrature,
    against a median |logit| of about 36."""
    import copy

    from xai_audio_deepfakes_tpu_torch.data.synthetic import (
        detector_corpus_anyband,
        make_anyband_corpus,
    )
    from xai_audio_deepfakes_tpu_torch.train import closed_loop, train_logreg
    from xai_audio_deepfakes_tpu_torch.train.train_addvisor import train_addvisor

    pipe = pipes["bfloat16"]
    cfg, dev = pipe.cfg, pipe.device
    n, sc = cfg.audio.num_samples, cfg.stft
    rng = np.random.default_rng(seed)
    real_tr, manip_tr, bands_tr = make_anyband_corpus(rng, N_TRAIN, n, sc, 1000.0, 8000.0,
                                                      NOISE_RMS, device=dev)
    real_ev, manip_ev, _ = make_anyband_corpus(rng, N_EVAL, n, sc, 1000.0, 8000.0, NOISE_RMS,
                                               device=dev)
    det_wavs, y = detector_corpus_anyband(real_tr, manip_tr, sc, bands_tr, 1000.0, 8000.0,
                                          rng=rng, noise_rms=NOISE_RMS, device=dev)
    y_ev = np.concatenate([np.zeros(N_EVAL, np.int64), np.ones(N_EVAL, np.int64)])
    shuffle_rng = copy.deepcopy(rng)  # where the first epoch's shuffle finds it
    untrained = copy.deepcopy(pipe.unet.state_dict())

    def epoch_1(head: dict) -> dict:
        pipe.unet.load_state_dict(untrained)
        pipe.logreg = head
        r, order, recs = copy.deepcopy(shuffle_rng), np.arange(N_TRAIN), []

        def batches():
            r.shuffle(order)
            return [manip_tr[order[i:i + BATCH_SIZE]]
                    for i in range(0, N_TRAIN - BATCH_SIZE + 1, BATCH_SIZE)]

        train_addvisor(pipe, batches, num_epochs=1, log_fn=recs.append)
        return recs[0]

    def epoch_1_summary(head: dict) -> dict:
        t0 = time.perf_counter()
        rec = epoch_1(head)
        out = {"s": time.perf_counter() - t0,
               **{k: rec[k] for k in ("loss", "l_in", "l_out", "l1", "w")}}
        if record_l_out is not None:
            out["l_out_over_record"] = rec["l_out"] / record_l_out
        return out

    fits = {"f32": train_logreg.train_detector, "bf16_operands": train_detector_bf16_operands}
    ways: dict = {}
    embeds: dict = {}
    for name, dtype, batch, fit in PROBE_WAYS:
        t0 = time.perf_counter()
        if (dtype, batch) not in embeds:
            embeds[dtype, batch] = (closed_loop.embed_mean(pipes[dtype], det_wavs, batch),
                                    np.concatenate([closed_loop.embed_mean(pipes[dtype], w, batch)
                                                    for w in (real_ev, manip_ev)]))
        x, x_ev = embeds[dtype, batch]
        way: dict = {"dtype": dtype, "batch": batch, "fit": fit,
                     "embed_s": time.perf_counter() - t0}
        same = next((k for k, v in ways.items() if v["fit"] == fit
                     and np.array_equal(embeds[v["dtype"], v["batch"]][0], x)
                     and np.array_equal(embeds[v["dtype"], v["batch"]][1], x_ev)), None)
        if same is not None:
            ways[name] = {**way, "bit_equal_to": same}
            print(json.dumps({"head_probe": name, **ways[name]}), flush=True)
            continue
        x0, x0_ev = embeds[PROBE_WAYS[0][1:3]]
        both, both0 = np.concatenate([x, x_ev]), np.concatenate([x0, x0_ev])
        diff = np.abs(both.astype(np.float64) - both0)
        way["embedding_vs_protocol"] = {
            "max_rel": float(diff.max() / np.abs(both0).max()),
            "mean_rel": float(diff.mean() / np.abs(both0).mean())}
        lbfgs: list = []
        t0 = time.perf_counter()
        head, split = fits[fit](x, y, log_fn=lbfgs.append, device=dev)
        way["fit_s"] = time.perf_counter() - t0
        way["lbfgs"] = next(r["lbfgs"] for r in lbfgs if "lbfgs" in r)
        way.update(fit_summary(torch, x, y, head))
        w = head["weight"].cpu().numpy()[:, 0].astype(np.float64)
        w0 = ways[PROBE_WAYS[0][0]]["w"] if ways else w
        way["cosine_to_protocol_head"] = float(w @ w0 / (np.linalg.norm(w) * np.linalg.norm(w0)))
        way["split"] = split
        way["held_out"] = train_logreg.evaluate_logreg(head, x_ev, y_ev)
        way["epoch_1"] = epoch_1_summary(head)
        if fit == "bf16_operands":
            way["epoch_1_weight_rounded"] = epoch_1_summary(
                {"weight": round_bf16(head["weight"]), "bias": head["bias"]})
        print(json.dumps({"head_probe": name, **way}), flush=True)
        ways[name] = {**way, "w": w}
    # the spread over the heads the port's own f32 fit gives
    l_outs = [v["epoch_1"]["l_out"] for v in ways.values() if "epoch_1" in v and v["fit"] == "f32"]
    for v in ways.values():
        v.pop("w", None)
    return {"rows": int(len(y)), "ways": ways, "record_l_out": record_l_out,
            "l_out_max_over_min": max(l_outs) / min(l_outs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--f32-embedder", action="store_true",
                    help="the control: embedder in f32, remat off")
    ap.add_argument("--reference-draw", action="store_true",
                    help="the JAX package's init_params(PRNGKey(seed)) weights, replayed")
    ap.add_argument("--l1-scale", type=float, default=None,
                    help="multiplier on the L1 term (default: the reference formula, 1.0)")
    ap.add_argument("--save-decoder", default=None,
                    help="write the trained UNet's state dict here")
    ap.add_argument("--probe", action="store_true",
                    help="the BatchNorm-mode probe on the after_train clips")
    ap.add_argument("--head-probe", action="store_true",
                    help="stop after epoch 1: the detector head fitted on four embeddings "
                         "of the same corpus, epoch 1 run with each (needs --reference-draw)")
    ap.add_argument("--out", default=None, help="write the result JSON here")
    ap.add_argument("--bf16-operand-fit", action="store_true",
                    help="fit the detector with its products' operands rounded to bf16, as a "
                         "TPU's default matmul precision takes them")
    args = ap.parse_args()
    if args.head_probe and not args.reference_draw:
        ap.error("--head-probe needs --reference-draw")
    if args.head_probe and args.bf16_operand_fit:
        ap.error("--head-probe fits the rounded head as one of its ways; "
                 "--bf16-operand-fit runs the whole protocol with it")

    if not torch.cuda.is_available():
        print("closed_loop_protocol: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))

    from xai_audio_deepfakes_tpu_torch.convert import load_jax_params
    from xai_audio_deepfakes_tpu_torch.data.synthetic import make_anyband_corpus
    from xai_audio_deepfakes_tpu_torch.reference_draw import jax_init_params
    from xai_audio_deepfakes_tpu_torch.train import closed_loop, train_logreg

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cfg = closed_loop.anyband_protocol_config()
    if args.f32_embedder:
        cfg = cfg.replace(embedder=dataclasses.replace(cfg.embedder, dtype="float32",
                                                       remat=False))
    phases: dict = {}
    log: list = []
    record = load_record(args.l1_scale) if args.reference_draw and args.seed == 0 else None
    witness: dict = {}

    t0 = time.perf_counter()
    pipe = closed_loop.ADDvisorPipeline(cfg, device="cuda", seed=args.seed)
    if args.reference_draw:
        t1 = time.perf_counter()
        params = jax_init_params(cfg, args.seed)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        load_jax_params(pipe, params)
        if args.head_probe:
            f32 = cfg.replace(embedder=dataclasses.replace(cfg.embedder, dtype="float32",
                                                           remat=False))
            pipe_f32 = closed_loop.ADDvisorPipeline(f32, device="cuda", seed=args.seed)
            load_jax_params(pipe_f32, params)
        del params
        torch.cuda.synchronize()
        phases["reference_draw"], phases["load_jax_params"] = t2 - t1, time.perf_counter() - t2
        t0 += time.perf_counter() - t1  # wall_s: the build and the loop, as without the replay
        print(json.dumps({"reference_draw_s": phases["reference_draw"],
                          "load_jax_params_s": phases["load_jax_params"]}), flush=True)
    if args.head_probe:
        t1 = time.perf_counter()
        out = {"device": {"name_power_limit": smi, "kind": torch.cuda.get_device_name(0)},
               "args": vars(args),
               **head_probe(torch, {"bfloat16": pipe, "float32": pipe_f32}, args.seed,
                            record[1][0]["l_out"] if record is not None else None),
               "head_probe_s": time.perf_counter() - t1, "phase_s": phases}
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(out, indent=1))
        print(json.dumps(out))
        return 0
    kept = (record_batch_stats(torch, pipe.unet, N_TRAIN // BATCH_SIZE)
            if args.probe else None)

    def log_fn(rec: dict) -> None:
        log.append(rec)
        if "epoch" in rec:
            phases.setdefault("first_epoch_record", time.perf_counter())
        print(json.dumps(rec), flush=True)
        if record is not None and rec.get("epoch") == 1:
            witness["epoch_1"] = epoch_witness(rec, record[1][0])
            print(json.dumps({"witness_epoch_1": witness["epoch_1"]}), flush=True)

    def timed(name, fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            phases[name] = phases.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapped

    for name in ("make_anyband_corpus", "detector_corpus_anyband", "train_detector",
                 "evaluate_explanations", "train_addvisor"):
        setattr(closed_loop, name, timed(name, getattr(closed_loop, name)))
    fit: dict = {}
    if args.bf16_operand_fit:
        closed_loop.train_detector = timed("train_detector", train_detector_bf16_operands)
    train_detector = closed_loop.train_detector

    def recorded_train_detector(x, y, **kw):
        params, metrics = train_detector(x, y, **kw)
        fit.update(fit_summary(torch, x, y, params))
        return params, metrics

    closed_loop.train_detector = recorded_train_detector
    res = closed_loop.run_closed_loop(
        cfg, seed=args.seed, n_train=N_TRAIN, n_eval=N_EVAL, epochs=EPOCHS,
        batch_size=BATCH_SIZE, noise_rms=NOISE_RMS, anyband=True, log_fn=log_fn,
        l1_scale=args.l1_scale, pipe=pipe)
    wall = time.perf_counter() - t0
    phases.pop("first_epoch_record", None)
    if args.save_decoder:
        Path(args.save_decoder).parent.mkdir(parents=True, exist_ok=True)
        torch.save(pipe.unet.state_dict(), args.save_decoder)
    extra: dict = {}
    if record is not None:
        witness["detector"] = detector_witness(record[0], res["detector"],
                                               res["detector_holdout"])
        extra["witness"] = witness
    if kept is not None:
        # the clips `after_train` explains: the first N_EVAL training clips,
        # the first corpus the seed's rng draws
        t1 = time.perf_counter()
        _, manip_tr, _ = make_anyband_corpus(
            np.random.default_rng(args.seed), N_TRAIN, cfg.audio.num_samples, cfg.stft, 1000.0,
            8000.0, NOISE_RMS, device=pipe.device)
        extra["bn_gap_last_epoch"] = bn_gaps(torch, pipe.unet, kept)
        extra["probe"] = probe(torch, pipe, res["state"], manip_tr[:N_EVAL], BATCH_SIZE)
        extra["probe"]["after_train_flip_rate"] = res["after_train"]["flip_rate"]
        phases["probe"] = time.perf_counter() - t1

    records = [r for r in log if "epoch" in r]
    # an epoch's `sec` is the host's time between its boundaries; the epoch
    # loop finalises records one epoch late and drains only after the last,
    # so the middle epochs' mean is the steady rate (the first holds the
    # first step's set-up, the last the drain)
    middle = [r["sec"] for r in records[1:-1]] or [r["sec"] for r in records]
    steady = sum(middle) / len(middle)
    clips = (N_TRAIN // BATCH_SIZE) * BATCH_SIZE
    drop = ("masks", "magnitude", "relevant_wavs", "irrelevant_wavs", "probs", "per_clip")
    summary = {
        "device": {"name_power_limit": smi, "kind": torch.cuda.get_device_name(0)},
        "args": {**vars(args), "n_train": N_TRAIN, "n_eval": N_EVAL, "epochs": EPOCHS,
                 "batch_size": BATCH_SIZE, "noise_rms": NOISE_RMS,
                 "embedder": dataclasses.asdict(cfg.embedder)},
        "detector": res["detector"],
        "detector_fit": {**fit, "seconds": phases["train_detector"],
                         "lbfgs": next(r["lbfgs"] for r in log if "lbfgs" in r)},
        "detector_holdout": res["detector_holdout"],
        **{phase: {k: ({kk: vv for kk, vv in v.items() if kk not in drop}
                       if isinstance(v, dict) else v)
                   for k, v in res[phase].items()}
           for phase in ("before", "after", "after_train")},
        "epoch_sec_first": records[0]["sec"], "epoch_sec_last": records[-1]["sec"],
        "epoch_sec_steady": steady, "clips_per_s_steady": clips / steady,
        "final_record": records[-1], "wall_s": wall, "phase_s": phases, **extra,
    }
    if record is not None:
        summary["against_record"] = against_record(records, record[1])
        summary["witness"]["untrained_masks"] = untrained_witness(
            res["before"]["localization"]["per_clip"], record[0]["before"]["localization"]["per_clip"])
    if args.out:
        path = Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({**summary, "train_log": records}, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
