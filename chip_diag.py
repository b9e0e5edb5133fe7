#!/usr/bin/env python3
"""Diagnostics of the PyTorch/CUDA port on one NVIDIA card, beside
`chip_smoke.py` (whose helpers they use) and never run by it: each prints
the readings that `PERF.md` cites for it.

    python3 chip_diag.py remat-off DIR [DIR ...]
        "training remat off, 3 steps" of `chip_smoke.py` (bf16 embedder with
        both fused frontend kernels, f32 UNet, 2 clips) from the checkout at
        each DIR in turn, each in its own process (`chip_smoke._remat_steps`
        of that checkout): step ms and peak memory. Name the checkouts
        parent, change, change, parent to compare two commits in one call.
    python3 chip_diag.py unet-trace [--seeds 11 5 4]
        the tiny bf16 UNet of `bench.py`'s default configuration on the card
        against the CPU, layer by layer (`unet_trace`).
    python3 chip_diag.py int8-sweep [--seeds 12] [--init lecun_normal|normal] [--out F]
        the int8 checks of `chip_smoke.tiny_int8_case` over weight seeds
        0..N-1, for each tiny int8 configuration and the bench default with
        the f32 UNet; `--init normal` draws the weights from the untruncated
        N(0, 1/fan_in) the port used before `models/init.py::lecun_normal_`.

    python3 chip_diag.py unet-bar [--seeds 24] [--out F]
        the derivation of check (ii)'s per-draw bar on a bf16 UNet's outputs
        (`chip_smoke.ii_bars`): `chip_smoke.tiny_int8_case` of each tiny
        int8 configuration with the bf16 UNet at weight seeds 0..N-1, per
        seed and output the card's deviation from the pinned CPU over the
        per-draw bar and over the 0.4x bf16 bar (`unet_bar`).

    python3 chip_diag.py detector-fits [--seed 2] [--out F] DIR [DIR ...]
        the anyband protocol's detector corpus at `--seed`
        (`closed_loop_protocol.py`'s sizes and configuration, built and
        embedded on the card; the run stops before the fit), then
        `fit_logreg` from the checkout at each DIR in turn, each in its own
        process, on the corpus's training split (seconds, steps, |w|, the
        median |logit|), each against the same objective fitted in float64
        for up to 20,000 steps (`closed_loop_protocol.float64_fit`; its
        objective over the float64 one, cosine).

Every command exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

REMAT_OFF = """
import sys
sys.path.insert(0, '.')
import numpy as np, torch, chip_smoke
from xai_audio_deepfakes_tpu_torch.config import EmbedderConfig, PipelineConfig
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cfg = PipelineConfig(embedder=EmbedderConfig(dtype="bfloat16", fused_ln_gelu=True, fused_conv=True))
rng = np.random.default_rng(4)
wavs = [(rng.standard_normal((2, cfg.audio.num_samples)) * 0.1).astype(np.float32) for _ in range(3)]
chip_smoke._remat_steps(torch, cfg, wavs, "off")
"""


def remat_off(dirs: list) -> int:
    rc = 0
    for d in dirs:
        print(f"== training remat off in {d}", flush=True)
        rc |= subprocess.run([sys.executable, "-c", REMAT_OFF], cwd=d, timeout=900).returncode
    return rc


FIT = """
import json, sys, time
sys.path.insert(0, '.')
import numpy as np, torch
from xai_audio_deepfakes_tpu_torch.train import train_logreg
d = np.load(sys.argv[1])
logs = []
torch.cuda.synchronize()
t0 = time.perf_counter()
p = train_logreg.fit_logreg(d["x"], d["y"], log_fn=logs.append)
torch.cuda.synchronize()
sec = time.perf_counter() - t0
np.savez(sys.argv[2], w=p["weight"].cpu().numpy()[:, 0], b=p["bias"].cpu().numpy())
print(json.dumps({"seconds": sec, **logs[0]["lbfgs"]}))
"""


class _Corpus(Exception):
    pass


def detector_fits(torch, seed: int, dirs: list) -> dict:
    import numpy as np

    import closed_loop_protocol as clp
    from xai_audio_deepfakes_tpu_torch.train import closed_loop, train_logreg

    def stop(x, y, **kw):
        raise _Corpus(x, y)

    closed_loop.train_detector, keep = stop, closed_loop.train_detector
    try:
        closed_loop.run_closed_loop(
            closed_loop.anyband_protocol_config(), seed=seed, n_train=clp.N_TRAIN,
            n_eval=clp.N_EVAL, epochs=clp.EPOCHS, batch_size=clp.BATCH_SIZE,
            noise_rms=clp.NOISE_RMS, anyband=True)
        raise RuntimeError("run_closed_loop fitted no detector")
    except _Corpus as e:
        x, y = e.args
    finally:
        closed_loop.train_detector = keep
    x_tr, _, y_tr, _ = train_logreg.stratified_split(x, y)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    np.savez(build / "detector_corpus.npz", x=x_tr, y=y_tr)
    steps, gnorm, w64, b64, objective = clp.float64_fit(torch, x_tr, y_tr, 20000)
    best = objective(w64, b64)
    res = {"seed": seed, "rows": int(len(x)), "train_rows": int(len(x_tr)),
           "features": int(x.shape[1]),
           "float64": {"steps": steps, "gnorm": gnorm, "objective": best,
                       "w_norm": float(np.linalg.norm(w64))}, "fits": {}}
    for d in dirs:
        out = subprocess.run([sys.executable, "-c", FIT, str(build / "detector_corpus.npz"),
                              str(build / "detector_fit.npz")], cwd=d, timeout=600,
                             capture_output=True, text=True, check=True)
        fit = json.loads(out.stdout.strip().splitlines()[-1])
        f = np.load(build / "detector_fit.npz")
        w, b = f["w"].astype(np.float64), float(f["b"][0])
        z = x_tr.astype(np.float64) @ w + b
        fit.update(w_norm=float(np.linalg.norm(w)), median_abs_logit=float(np.median(np.abs(z))),
                   objective_over_float64=objective(w, b) / best,
                   cosine_to_float64=float(w @ w64 / (np.linalg.norm(w) * np.linalg.norm(w64))))
        res["fits"][d] = fit
        print(d, json.dumps(fit), flush=True)
    return res


def bf16_ulps(a, b):
    """|a - b| in bf16 steps at max(|a|, |b|) (a step is 2^(e - 7) for a
    value in [2^e, 2^(e+1)); zero where both are zero)."""
    import torch

    a, b = a.double(), b.double()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(2.0**-126)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (a - b).abs() / step


def round_once(m, x):
    """`m`'s (a port `Conv2d` / `ConvTranspose2d`, float path) bf16 output
    as one f64 product of its bf16 operands rounded once to bf16, the bias
    added in bf16 (the cast points of `models/unet.py`)."""
    import torch
    import torch.nn.functional as F

    from xai_audio_deepfakes_tpu_torch.models import unet

    xd = x.cpu().to(torch.bfloat16).double()
    wd = m.weight.detach().cpu().to(torch.bfloat16).double()
    if isinstance(m, unet.ConvTranspose2d):
        y = F.conv_transpose2d(xd, wd, None, m.stride)
    else:
        y = F.conv2d(xd, wd, None, m.stride, m.padding, m.dilation)
    return y.to(torch.bfloat16) + m.bias.detach().cpu().to(torch.bfloat16)[:, None, None]


def record(module, names):
    """Forward hooks on `module`'s submodules `names` -> ({name: (input,
    output)} filled on each call, the hook handles)."""
    got, handles = {}, []
    for name in names:
        def hook(_, inputs, output, name=name):
            got[name] = (inputs[0].detach().cpu().clone(), output.detach().cpu().clone())
        handles.append(module.get_submodule(name).register_forward_hook(hook))
    return got, handles


def unet_trace(torch, seeds: list) -> dict:
    """For each seed, the tiny bench-default pipelines of
    `chip_smoke.tiny_case_pipes` (card, CPU with the same weights, f32 CPU).
    The card's explain records every conv, transposed conv, BatchNorm and
    leaky ReLU of the UNet (input and output). Per layer, in call order:
      same input: the CPU's layer on the card's input, elements that differ
        from the card's output and the largest difference in bf16 steps;
      round once: for a conv, the card's and the CPU's output each against
        the f64 product of the same bf16 operands rounded once to bf16;
      chain: the CPU's UNet run on the card's UNet input, its mean |card -
        CPU| over the mean |CPU - f32 CPU| at that layer.
    Then the mask and both waveforms, mean |card - CPU| over mean |CPU - f32|
    (the ratio check (ii)'s mean bar holds at 0.4), with the CPU UNet fed
    the card's input and its own."""
    import chip_smoke
    from xai_audio_deepfakes_tpu_torch.models import unet as unet_mod

    emb, un = chip_smoke.TINY_INT8_CASES["bench default (bf16, int8, tanh, bf16 UNet)"]
    g = torch.Generator().manual_seed(6)
    wav = torch.randn(2, 8000, generator=g) * 0.1
    kinds = (unet_mod.Conv2d, unet_mod.ConvTranspose2d, unet_mod.BatchNorm2d, torch.nn.LeakyReLU)
    result = {}
    for seed in seeds:
        cfg, (gpu, cpu, f32) = chip_smoke.tiny_case_pipes(torch, emb, un, seed)
        names = [n for n, m in gpu.unet.named_modules() if isinstance(m, kinds)]
        top: dict = {}

        def keep(_, inputs, output, key):
            top[key] = (inputs[0].detach().cpu().clone(), output.detach().cpu().clone())

        hooks = [p.unet.register_forward_hook(lambda *a, k=k: keep(*a, k))
                 for k, p in (("card", gpu), ("cpu", cpu))]
        card_layers, handles = record(gpu.unet, names)
        outs = {"card": gpu.explain(wav.cuda()), "cpu": cpu.explain(wav)}
        torch.cuda.synchronize()
        for h in hooks + handles:
            h.remove()
        outs["f32"] = f32.explain(wav)
        card_in = top["card"][0]
        with torch.inference_mode():
            cpu_chain, h1 = record(cpu.unet, names)
            cpu_mask_from_card = cpu.unet(card_in)
            for h in h1:
                h.remove()
            f32_chain, h2 = record(f32.unet, names)
            f32_mask_from_card = f32.unet(card_in)
            for h in h2:
                h.remove()
        rows = []
        with torch.inference_mode():
            for name in names:
                x, y_card = card_layers[name]
                m = cpu.unet.get_submodule(name)
                y_cpu = m(x)
                d = bf16_ulps(y_card.float(), y_cpu.float())
                row = {"layer": name, "kind": type(m).__name__, "shape": list(y_card.shape),
                       "dtype": str(y_card.dtype).removeprefix("torch."),
                       "same_input_off": int((d > 0).sum()), "n": y_card.numel(),
                       "same_input_max_steps": float(d.max())}
                if isinstance(m, (unet_mod.Conv2d, unet_mod.ConvTranspose2d)):
                    ref = round_once(m, x)
                    for who, y in (("card", y_card), ("cpu", y_cpu)):
                        r = bf16_ulps(y.float(), ref.float())
                        row[f"round_once_{who}_off"] = int((r > 0).sum())
                        row[f"round_once_{who}_max_steps"] = float(r.max())
                own = (cpu_chain[name][1].float() - f32_chain[name][1].float()).abs().mean()
                err = (y_card.float() - cpu_chain[name][1].float()).abs().mean()
                row["chain_ratio"] = float(err / own) if float(own) else 0.0
                rows.append(row)

        def ratio(key, cpu_out):
            want_f32 = getattr(outs["f32"], key).cpu()
            err = (getattr(outs["card"], key).cpu() - cpu_out).abs().mean()
            return float(err / (getattr(outs["cpu"], key).cpu() - want_f32).abs().mean())

        finals = {key: ratio(key, getattr(outs["cpu"], key)) for key in chip_smoke.EXPLAIN_KEYS}
        in_err = float((card_in - top["cpu"][0]).abs().max())
        finals["mask, the CPU UNet on the card's input"] = float(
            (top["card"][1] - cpu_mask_from_card).abs().mean()
            / (cpu_mask_from_card - f32_mask_from_card).abs().mean())
        print(f"== unet trace, seed {seed}: UNet input card vs CPU max_abs_err {in_err:.3e}")
        for r in rows:
            once = (f", round once card {r['round_once_card_off']} (max {r['round_once_card_max_steps']:g}),"
                    f" CPU {r['round_once_cpu_off']} (max {r['round_once_cpu_max_steps']:g})"
                    if "round_once_card_off" in r else "")
            print(f"  {r['layer']} {r['kind']} {r['dtype']} {r['shape']}: same input off "
                  f"{r['same_input_off']} of {r['n']} (max {r['same_input_max_steps']:g} bf16 "
                  f"steps){once}, chain ratio {r['chain_ratio']:.3f}")
        print("  final mean ratios (check (ii)'s bar 0.4): " + json.dumps(finals))
        result[seed] = {"input_max_abs_err": in_err, "layers": rows, "finals": finals}
    return result


def normal_init_(weight, fan_in: int, generator):
    """The port's initialiser before lecun_normal: an untruncated
    N(0, 1/fan_in) drawn in the weight's dtype."""
    import torch

    with torch.no_grad():
        weight.normal_(0.0, fan_in**-0.5, generator=generator)
    return weight


def int8_sweep(torch, seeds: int = 12, init: str = "lecun_normal") -> dict:
    """The int8 checks of `chip_smoke.tiny_int8_case` over `seeds` weight
    seeds, each of `SWEEP_CASES`: pass counts of the former bar (1/10 of
    the int8-vs-f32 relative L2), of checks (i), (ii), (iii) and of all
    three, and each run's printed lines."""
    import chip_smoke
    from xai_audio_deepfakes_tpu_torch.models import hifigan, unet, wav2vec2

    cases = {**chip_smoke.TINY_INT8_CASES,  # and the bench default with the f32 UNet
             "bench default, f32 UNet": (dict(dtype="bfloat16", quant="int8", gelu="tanh"), {})}
    modules = (wav2vec2, unet, hifigan)
    saved = [m.lecun_normal_ for m in modules]
    if init == "normal":
        for m in modules:
            m.lecun_normal_ = normal_init_
    result: dict = {}
    try:
        for case, (emb, un) in cases.items():
            counts = dict.fromkeys(("old", "i", "ii", "iii", "all"), 0)
            per_seed = []
            for seed in range(seeds):
                res = chip_smoke.tiny_int8_case(torch, emb, un, seed=seed)
                res["all"] = res["i"] and res["ii"] and res["iii"]
                for k in counts:
                    counts[k] += bool(res[k])
                per_seed.append({k: bool(res[k]) for k in counts} | {"lines": res["lines"]})
            result[f"{case} | {init}"] = {"passes": counts, "seeds": seeds, "per_seed": per_seed}
            print(f"int8 sweep, {case}, {init} initialiser: passes of {seeds} seeds "
                  + json.dumps(counts), flush=True)
    finally:
        for m, fn in zip(modules, saved):
            m.lecun_normal_ = fn
    return result


def unet_bar(torch, seeds: int = 24) -> dict:
    """Per seed 0..seeds-1 and tiny int8 configuration with the bf16 UNet:
    for each output of the UNet (mask, both waveforms) the card's mean and
    max deviation from the pinned CPU explain over the per-draw bar's
    (`ratio`: the larger of the two; the bar holds at 1) and over the bf16
    bars' (`ratio_0.4x`), with checks (i), (ii) and (iii) as
    `tiny_int8_case` holds them at that seed; then the pass counts and the
    largest ratios."""
    import chip_smoke

    result: dict = {}
    for case, (emb, un) in chip_smoke.TINY_INT8_CASES.items():
        if un.get("dtype") != "bfloat16":
            continue
        rows = []
        for seed in range(seeds):
            res = chip_smoke.tiny_int8_case(torch, emb, un, seed=seed)
            row = {"seed": seed, "i": res["i"], "ii": res["ii"], "iii": res["iii"], "outputs": {}}
            for key, pd in res["ii_per_draw"].items():
                old = res["ii_0.4x"][key]
                row["outputs"][key] = {
                    "mean_ratio": pd["mean"] / pd["mean_bar"], "max_ratio": pd["max"] / pd["max_bar"],
                    "mean_ratio_0.4x": old["mean"] / old["mean_bar"],
                    "max_ratio_0.4x": old["max"] / old["max_bar"], "per_draw": pd}
            outs = row["outputs"].values()
            row["ratio"] = max(max(o["mean_ratio"], o["max_ratio"]) for o in outs)
            row["ratio_0.4x"] = max(max(o["mean_ratio_0.4x"], o["max_ratio_0.4x"]) for o in outs)
            row["per_draw_holds"] = all(pd["holds"] for pd in res["ii_per_draw"].values())
            row["bf16_bars_hold"] = all(res["ii_0.4x"][k]["holds"] for k in res["ii_per_draw"])
            rows.append(row)
            print(f"unet bar, {case}, seed {seed}: per-draw ratio {row['ratio']:.3f} "
                  f"({'holds' if row['per_draw_holds'] else 'MISSES'}), 0.4x ratio "
                  f"{row['ratio_0.4x']:.3f}; per output (mean, max) "
                  + json.dumps({k: [round(o["mean_ratio"], 4), round(o["max_ratio"], 4)]
                                for k, o in row["outputs"].items()}), flush=True)
        summary = {"per_draw_holds": sum(r["per_draw_holds"] for r in rows),
                   "bf16_bars_hold": sum(r["bf16_bars_hold"] for r in rows),
                   "checks_hold": sum(r["i"] and r["ii"] and r["iii"] for r in rows),
                   "largest_ratio": max(r["ratio"] for r in rows),
                   "largest_ratio_0.4x": max(r["ratio_0.4x"] for r in rows), "seeds": seeds}
        print(f"unet bar, {case}: " + json.dumps(summary), flush=True)
        result[case] = {"summary": summary, "per_seed": rows}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("remat-off").add_argument("dirs", nargs="+")
    t = sub.add_parser("unet-trace")
    t.add_argument("--seeds", type=int, nargs="+", default=[11, 5, 4])
    t.add_argument("--out")
    s = sub.add_parser("int8-sweep")
    s.add_argument("--seeds", type=int, default=12)
    s.add_argument("--init", choices=("lecun_normal", "normal"), default="lecun_normal")
    s.add_argument("--out")
    b = sub.add_parser("unet-bar")
    b.add_argument("--seeds", type=int, default=24)
    b.add_argument("--out")
    f = sub.add_parser("detector-fits")
    f.add_argument("--seed", type=int, default=2)
    f.add_argument("--out")
    f.add_argument("dirs", nargs="+")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_diag: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.cmd == "remat-off":
        return remat_off(args.dirs)
    if args.cmd == "unet-trace":
        res = unet_trace(torch, args.seeds)
    elif args.cmd == "unet-bar":
        res = unet_bar(torch, args.seeds)
    elif args.cmd == "detector-fits":
        res = detector_fits(torch, args.seed, args.dirs)
    else:
        res = int8_sweep(torch, args.seeds, args.init)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
