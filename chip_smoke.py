#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. It

 1. prints the card's name and power limit (nvidia-smi);
 2. builds the hand-written kernels from `xai_audio_deepfakes_tpu_torch/csrc`
    and prints the build seconds and ptxas' register / shared-memory report,
    and counts the tensor-core instructions (HMMA / HGMMA) of the bf16
    bodies of attention and conv+LN+GELU in the library's SASS
    (`cuobjdump -sass`), neither of which may be 0;
 3. holds each kernel (A attention, B STFT, C iSTFT, D LayerNorm+GELU,
    E conv+LayerNorm+GELU) against its plain PyTorch version at every batch
    the driven paths give it (`EMBED_BATCHES`: embedder batches 1, 2, 4, 8,
    16 and 24 for A, D and E, and 48 for A, the closed loop's explain;
    `SPEC_BATCHES`: 1, 2, 8, 16 and 32 clips for B and C, and 1 and 8 in
    the Hann 1024 / hop 256 configuration of the mel frontend and the
    vocoded splices, B also timed at the mel shape [8, 80000] against its
    bytes bound), in f32 and in the working dtype, each beside its tolerance, and
    times, at the UNet explain's shapes (8 clips, embedder batch 24), the
    kernel, the plain version and one PyTorch library call that computes
    the same function (timed only; the port never calls it) by CUDA events;
    for every kernel also the device time per call of the kernel and of the
    library call from a torch.profiler trace (`kernel_device_ms`,
    `library_device_ms`; D and E summed over their shapes, E's with the
    wrapper's weight-image copy), which leave out the host's per-call
    overhead (a call whose traces show no kernel three times over is timed
    by CUDA events instead and named on a line before the `kernels` line);
    D is held at each of the seven frontend shapes in both dtypes and both
    GELU forms, with its bf16 elements off by any step and by more than one
    step (at most 0.1%), and timed layer by layer (ms, device ms, GB/s
    against 3.35 TB/s, beside the library's), with ptxas' registers and
    spills of its instantiations;
 4. holds the backward of A, C, D and E (forward through the kernel, backward
    by recomputation) against autograd through the plain version, at the
    training step's shapes (2 clips), in f32 and, for A, D and E, in bf16 as
    the attribution harness and the training step take it
    (`check_backwards_bf16`);
 5. runs `ADDvisorPipeline.explain(decoder="unet")` at the full width of the
    XLS-R-2B truncation (bf16 embedder, default UNet) on 8 seeded clips with
    random weights from a seeded torch.Generator, checks shapes, finiteness
    and probabilities in (0, 1), counts the kernel launches of one explain
    (A 9, B 1, C 2, D 7) and prints clips/s; then the same with
    `fused_conv=True` (A 9, B 1, C 2, D 1, E 6), whose probabilities must
    agree with the first run's within 0.05;
 6. takes LMAC training steps of the UNet decoder at full width and depth
    (bf16 embedder with both fused frontend kernels, f32 UNet, 2 clips;
    cuDNN's deterministic algorithms, as `make_train_step` takes them):
    launches per step A 27, B 1, C 2, D 3, E 18, finite losses, loss weights
    renormalised to sum 3, decoder changed, embedder bit-identical; prints
    step ms, its forward / backward / optimiser split and peak memory;
 7. runs a tiny f32 training step on the card and on the CPU with the same
    weights and compares them (losses 1e-4, decoder gradients 1e-3 of their
    scale, loss weights 1e-5);
 8. runs the JAX package's serving configurations at full width, B=8: the
    entry point's (`EmbedderConfig(dtype="bfloat16")`, unfused frontend
    LayerNorm and GELU), `bench.py`'s default (bf16, int8, tanh GELU, bf16
    UNet) and the same after `calibrate_quant` on 16 seeded clips
    (int8-static; prints the calibration's seconds), each with launches
    A 9, B 1, C 2, D 0, E 0, finite probabilities in (0, 1), explain ms,
    clips/s and the stage split by CUDA events; times the frontend's
    separate bf16 bias adds; and holds a tiny explain of each new
    configuration (with `quant_conv` and `UNetConfig.quant` once, and
    `fused_attention=False`) on the card against the CPU, at bars set by
    each configuration's own distance from the f32 port (`run_tiny_configs`);
    and saliency through `run_attribution_metrics` on `bench.py`'s int8
    embedder at batch 2 (A 36, a finite, non-zero map);
 9. runs `explain(decoder="features")` at full width, B=8, with both
    frontends (A 18, B 1, C 2, D 14; or D 2, E 12), its stage split and
    peak memory; `run_explanation_metrics` over 3 batches of 8 with each
    decoder, its device fold against the float64 summary of the
    probabilities (1e-5, relative above 1); each of the five attribution
    methods through `run_attribution_metrics` at batch 2 (IG 8 steps,
    SmoothGrad and GradientShap 4 samples; A 9 and D 7 per embedder
    forward, finite non-zero maps), with ms per method; the harness's
    saliency map twice, bit for bit equal (deterministic cuDNN), and the
    drift of two saliency maps with cuDNN's default algorithms (printed);
10. exports a seeded encoder as a HF checkpoint (weight-normed positional
    conv, `wav2vec2.` prefix), writes it as a hand-made `model.safetensors`
    (1.7 GB f32 at full width) and, at tiny width, as `pytorch_model.bin`,
    imports it through `params_from_hf_dir` and `convert.load_encoder`, and
    requires the explain to equal the source weights' bit for bit;
11. takes two identical no-remat training steps through `make_train_step`
    and requires bit-equal losses and decoder gradients, then three
    training steps with remat off, "full" and "dots" (step ms, peak memory,
    launches with the recomputed kernel A, the first step's decoder
    gradients against remat off at 1e-3 of their scale), and one
    feature-decoder step (A 27, B 1, C 2, D 3, E 18); and holds a tiny
    feature-decoder explain (one attention block) and a tiny f32
    `input_x_gradient` on the card against the CPU (mask 1e-5, waveforms
    2e-4, probabilities 1e-4; the map 1e-3 of its largest magnitude);
12. drives the detector and its data at full width: `datagen` as the CLI
    runs it (the entry point's configuration; 8 seeded clips and noise
    twins written as 16-bit wavs, the twins at 22.05 kHz, read back by
    `extract_wavs` and `load_audio`, which decoder served printed;
    `generate_band_swap_features` -> X [72, 1920], launches per pair A 18,
    B 2, C 1, ms per pair and its device split), `embed` (`AudioBatcher` at
    batch 4, pooled features and probabilities), the anyband corpus
    (`make_anyband_corpus(n=16)`, `detector_corpus_anyband`) on the card
    against the CPU (2e-4, labels equal), embedded at batch 8 in the kernel
    D configuration, `train_detector` (accuracy, EER, L-BFGS steps,
    seconds), the head saved, reloaded and installed in the pipeline
    (`classify` against the fitted head, 1e-6), `per_clip_band_stats` over
    two explains' masks (finite); `fit_logreg` on [4096, 1920] against
    scipy's float64 L-BFGS-B (cosine > 0.999, objective 1e-4 relative); and
    tiny `band_spliced_waveforms` (2e-4) and band-swap features (5e-4) on
    the card against the CPU;
13. takes one training step at 2 clips with each switch ported last (the
    bf16 UNet; `target_quant="int8"`) in the kernel D + E configuration
    (A 27, B 1, C 2, D 3, E 18; step ms and peak memory beside the f32
    step's), and a tiny step of each on the card against the CPU (the
    int8 target at the training bars, the bf16 UNet at multiples of its
    own bf16-vs-f32 deviation);
14. drives the vocoder at full width over 8 clips (default `HiFiGANConfig`,
    f32, 512 initial channels): `vocode` (B 1, [8, 80128]), its mel /
    HiFi-GAN split and peak memory, `explain_vocoded` (A 9, B 2, C 2) with
    the explain and the HiFi-GAN timed apart, `generate_vocoded_dataset`
    over datagen's 8 wavs (64 band-spliced wavs, a file B 3, C 1, leakage
    warnings counted), and a tiny `explain_vocoded` on the card against
    the CPU;
15. runs the closed loop reduced (`run_closed_loop(anyband=True)`, 32
    training and 16 evaluation clips, 3 epochs at batch 16) in the
    configuration of `docs/closed_loop_anyband`'s command line (bf16,
    `scan_layers`, remat "dots", lr 3e-4, noise rms 1.0): the detector's
    accuracy and EER, epoch records with `sec`, localisation, keep and
    flip rates before and after, launches per stage; every epoch
    checkpointed asynchronously (each checkpoint its epoch's state, the
    last reloaded bit for bit) and `artifact_fn` once per epoch;
16. last of the phases, a tiny f32 explain on the card 20 times against
    one on the CPU with the same weights (mask 1e-5, waveforms 2e-4,
    probabilities 1e-4), the largest deviations printed;
17. prints the `kernels` JSON line and, last, the device line. A kernel's
    `launches` are those of every driven path together, each path counted
    from zero and named in `launches_by_path`; its `body` names the design
    that ran.

Any failed phase exits non-zero without the last line. Without CUDA it exits
1 before printing anything.
"""

from __future__ import annotations

import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

BATCH = 8  # clips per explain; the embedder runs 3 * BATCH
CORPUS = 16  # clips of the anyband detector corpus
LOOP_BATCH = 16  # the closed loop's batch (the anyband protocol's)
LOOP_TRAIN = 32  # training clips of the reduced closed loop (its corpora's batch)
# the batches the driven paths give the kernels, each held at all of them:
# the embedder (A, D, E) runs at 1 (datagen's real clip), 2 (training steps,
# attribution), 4 (the embed loop), BATCH (datagen's 8 band splices, the
# corpus embed, the feature decoder's clean embed), 2 * BATCH (its masked
# clips; the closed loop's embeds and its loss's relevant and irrelevant
# clips, LOOP_BATCH each) and 3 * BATCH (the UNet explain); A also at
# 3 * LOOP_BATCH (the closed loop's explains); the STFT and iSTFT (B, C) at
# 1 (datagen's clip and twin), 2, BATCH (the splices' iSTFT), CORPUS (and
# LOOP_BATCH) and LOOP_TRAIN (the closed loop's corpora), and in the Hann
# 1024 / hop 256 configuration of the mel frontend and the vocoded splices
# at 1 (a file's mel, its splice's STFTs) and BATCH (the mel at [8, 80000],
# the eight band splices' iSTFT)
EMBED_BATCHES = (1, 2, 4, BATCH, 2 * BATCH, 3 * BATCH)
ATTENTION_BATCHES = EMBED_BATCHES + (3 * LOOP_BATCH,)
SPEC_BATCHES = (1, 2, BATCH, CORPUS, LOOP_TRAIN)
HANN_SPEC_BATCHES = (1, BATCH)
# peak rates of one H100 SXM (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over the
# peak rate of its input type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# device times that no profiler trace gave and CUDA events took instead
EVENT_TIMED: list = []


def kernel_device_ms(fn, match: str = "", iters: int = 20, tries: int = 3) -> float:
    """Device time of one call of fn() in the kernels whose names hold
    `match` (all kernels with the default), from a torch.profiler trace of
    `iters` calls: device time alone, without the host's per-call overhead
    that CUDA events around a small call take in. Now and then a trace holds
    no device activity at all; it is taken again, up to `tries` times, and
    then the call is timed by CUDA events and named in EVENT_TIMED."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = {(ev.name, ev.time_range.start, ev.time_range.end) for ev in prof.events()
                 if str(ev.device_type).endswith("CUDA") and match in ev.name}
        if spans:
            return sum(end - start for _, start, end in spans) / 1e3 / iters
    EVENT_TIMED.append(f"{fn.__qualname__} {match}".strip())
    print(f"  no trace of {tries} showed a kernel of {EVENT_TIMED[-1]}: timed by CUDA events")
    return time_ms(fn, iters=iters, warmup=0)


def check_close(name: str, got, want, atol: float, rtol: float = 0.0) -> float:
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite output")
    err = float((got - want).abs().max())
    ok = bool(((got - want).abs() <= atol + rtol * want.abs()).all())
    print(f"  {name}: max_abs_err {err:.3e} (atol {atol:g}, rtol {rtol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def bound_ms(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fft_frame_ops(n_fft: int) -> float:
    """Operations one windowed frame needs through a real-input FFT: half of a
    complex radix-2 FFT's 5 N log2 N, plus the window product. Kernels B and
    C compute a radix-8 FFT of the half-length complex frame (and C
    transforms ~1.4x the frames, the spans' overlap), but the bound counts
    the least work the function needs."""
    return 2.5 * n_fft * math.log2(n_fft) + n_fft


def check_sass(lib_path: Path) -> None:
    """Count the tensor-core instructions (HMMA, or HGMMA for wgmma) of the
    bf16 bodies of attention (A) and conv+LN+GELU (E) in the built library's
    SASS; fails if either has none."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        print("cuobjdump not found: SASS not checked")
        return
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts = {}
    for section in sass.split("Function : ")[1:]:
        name = section.split(maxsplit=1)[0]
        if "attention" in name or "conv_ln_gelu" in name:
            counts[name] = section.count("HMMA") + section.count("HGMMA")
    print(f"tensor-core instructions per attention / conv kernel (SASS): {counts}")
    for kernel in ("attention", "conv_ln_gelu"):
        if not any(n > 0 for name, n in counts.items() if kernel in name and "bf16" in name):
            fail(f"the bf16 {kernel} body has no tensor-core instruction")


def attention_inputs(torch, g, b: int, t: int, nh: int, hd: int, hdp: int, q_scale: float):
    """Head-padded [b, t, nh * hdp] q, k, v in f32: N(0, 1) in the first hd
    lanes of each head, exact zeros in the pad lanes, q times q_scale."""
    qkv = []
    for i in range(3):
        x = torch.zeros(b, t, nh, hdp, device="cuda")
        x[..., :hd] = torch.randn(b, t, nh, hd, device="cuda", generator=g)
        if i == 0:
            x *= q_scale
        qkv.append(x.reshape(b, t, nh * hdp))
    return qkv


def check_attention(torch, cfg, rows: list) -> None:
    from xai_audio_deepfakes_tpu_torch.ops.attention import attention, attention_plain

    e = cfg.embedder
    t, nh, hd, hdp = cfg.audio.num_frames(cfg.stft), e.num_heads, 120, 128
    g = torch.Generator(device="cuda").manual_seed(1)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for b in ATTENTION_BATCHES:
        qkv = attention_inputs(torch, g, b, t, nh, hd, hdp, q_scale=hd**-0.5)
        for dt, atol, rtol in ((torch.float32, 1e-5, 0.0), (torch.bfloat16, 1e-2, 1e-2)):
            q, k, v = (x.to(dt) for x in qkv)
            out = attention(q, k, v, nh)
            torch.cuda.synchronize()
            errs[dt] = max(errs[dt], check_close(f"A attention {dt} batch {b}", out,
                                                 attention_plain(q, k, v, nh), atol, rtol))
            pad = out.reshape(b, t, nh, hdp)[..., hd:]
            if bool(pad.any()):
                fail(f"A attention: pad lanes are not exactly zero at batch {b}")
            del out
        if b == 3 * BATCH:
            timed = qkv
    # timed at the UNet explain's batch
    b = 3 * BATCH
    q, k, v = (x.to(torch.bfloat16) for x in timed)
    heads = lambda x: x.reshape(b, t, nh, hdp).transpose(1, 2)  # noqa: E731
    qh, kh, vh = heads(q).contiguous(), heads(k).contiguous(), heads(v).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = time_ms(lambda: attention(q, k, v, nh))
    plain = time_ms(lambda: attention_plain(q, k, v, nh))
    lib = time_ms(lambda: sdpa(qh, kh, vh, scale=1.0))
    nbytes = 4 * b * t * nh * hdp * 2
    ops = 4 * b * nh * t * t * hdp
    bnd, by = bound_ms(nbytes, ops, "bfloat16")
    rows.append(dict(name="attention", route="cuda",
                     source="xai_audio_deepfakes_tpu_torch/csrc/attention.cu",
                     replaces="xai_audio_deepfakes_tpu/ops/attention.py:100",
                     max_abs_err=errs[torch.bfloat16], ms=ms, plain_ms=plain,
                     bound_ms=bnd, bound_by=by, library_ms=lib,
                     f32_max_abs_err=errs[torch.float32], shape=[b, t, nh * hdp],
                     kernel_device_ms=kernel_device_ms(lambda: attention(q, k, v, nh),
                                                       "attention_bf16_kernel"),
                     library_device_ms=kernel_device_ms(lambda: sdpa(qh, kh, vh, scale=1.0)),
                     dtype="bfloat16", body="bf16: mma.sync m16n8k16 from ldmatrix, cp.async K/V "
                     "ring, score row resident in registers for T <= 256 (two passes over K "
                     "beyond); f32: CUDA-core FMAs, score tile in shared memory"))


def check_stft(torch, cfg, rows: list) -> None:
    from xai_audio_deepfakes_tpu_torch.data.vocoded import hann_splice_config
    from xai_audio_deepfakes_tpu_torch.ops.cuda_stft import istft, stft
    from xai_audio_deepfakes_tpu_torch.ops.stft import (
        device_constant,
        istft_plain,
        stft_plain,
    )

    sc, n = cfg.stft, cfg.audio.num_samples
    hann = hann_splice_config()  # the mel frontend's STFT too (hann 1024 / hop 256)
    g = torch.Generator(device="cuda").manual_seed(2)
    err = err_c = 0.0
    timed = {}  # BATCH's inputs
    for conf, batches in ((sc, SPEC_BATCHES), (hann, HANN_SPEC_BATCHES)):
        tag = "" if conf is sc else " hann 1024/256"
        for b in batches:
            x = torch.randn(b, n, device="cuda", generator=g) * 0.3
            re, im = stft(x, conf)
            torch.cuda.synchronize()
            re_p, im_p = stft_plain(x, conf)
            err = max(err, check_close(f"B stft{tag} re batch {b}", re, re_p, 2e-4),
                      check_close(f"B stft{tag} im batch {b}", im, im_p, 2e-4))
            mask = torch.rand(re.shape, device="cuda", generator=g)
            re_m, im_m = (re_p * mask).contiguous(), (im_p * mask).contiguous()
            y = istft(re_m, im_m, conf, n)
            torch.cuda.synchronize()
            err_c = max(err_c, check_close(f"C istft{tag} batch {b}", y,
                                           istft_plain(re_m, im_m, conf, n), 2e-4))
            # randn spectra, as a gradient's: Im[0] and Im[M] non-zero, which
            # the plain version's bases ignore
            re_r, im_r = (torch.randn(re.shape, device="cuda", generator=g) for _ in range(2))
            err_c = max(err_c, check_close(f"C istft{tag}, randn spectra, batch {b}",
                                           istft(re_r, im_r, conf, n),
                                           istft_plain(re_r, im_r, conf, n), 2e-4))
            if b == BATCH:
                timed[conf] = x
    mel = check_stft_mel(torch, hann, timed[hann])
    x = timed[sc]
    re_p, im_p = stft_plain(x, sc)
    mask = torch.rand(re_p.shape, device="cuda", generator=g)
    re_m, im_m = (re_p * mask).contiguous(), (im_p * mask).contiguous()
    t = re_p.shape[-1]
    win = device_constant("window", x.device, sc.window, sc.win_length, sc.n_fft)
    def stft_lib():
        return torch.stft(x, sc.n_fft, sc.hop_length, sc.n_fft, win, center=True,
                          pad_mode="reflect", return_complex=True)

    lib = time_ms(stft_lib)
    ops = BATCH * t * fft_frame_ops(sc.n_fft)
    # the signal read once, re and im written once (the inverse moves the same)
    nbytes = 4 * (BATCH * n + 2 * BATCH * sc.num_bins * t)
    bnd, by = bound_ms(nbytes, ops, "float32")
    rows.append(dict(name="stft", route="cuda", source="xai_audio_deepfakes_tpu_torch/csrc/stft.cu",
                     replaces="xai_audio_deepfakes_tpu/ops/pallas_stft.py:107",
                     max_abs_err=err, ms=time_ms(lambda: stft(x, sc)),
                     plain_ms=time_ms(lambda: stft_plain(x, sc)), bound_ms=bnd, bound_by=by,
                     library_ms=lib, shape=[BATCH, n], dtype="float32",
                     kernel_device_ms=kernel_device_ms(lambda: stft(x, sc), "stft_fft_kernel"),
                     library_device_ms=kernel_device_ms(stft_lib), mel_shape=mel,
                     body="radix-8 Stockham FFT of the even/odd-packed frame in shared memory, "
                     "split step, reflect pad folded into the read"))

    spec = torch.complex(re_m, im_m)
    def istft_lib():
        return torch.istft(spec, sc.n_fft, sc.hop_length, sc.n_fft, win, center=True, length=n)

    lib = time_ms(istft_lib)
    # per frame the inverse FFT and window, plus overlap-add and envelope
    # division per output sample
    bnd, by = bound_ms(nbytes, ops + 2 * BATCH * n, "float32")
    rows.append(dict(name="istft", route="cuda", source="xai_audio_deepfakes_tpu_torch/csrc/istft.cu",
                     replaces="xai_audio_deepfakes_tpu/ops/pallas_stft.py:210",
                     max_abs_err=err_c, ms=time_ms(lambda: istft(re_m, im_m, sc, n)),
                     plain_ms=time_ms(lambda: istft_plain(re_m, im_m, sc, n)),
                     bound_ms=bnd, bound_by=by, library_ms=lib,
                     shape=[BATCH, sc.num_bins, t], dtype="float32",
                     kernel_device_ms=kernel_device_ms(lambda: istft(re_m, im_m, sc, n),
                                                       "istft_fft_kernel"),
                     library_device_ms=kernel_device_ms(istft_lib),
                     body="inverse real FFT (half-length pack, radix-8 Stockham core shared "
                     "with B) of the frames touching each 8-hop span, windowed overlap-add "
                     "gathered in shared memory, envelope, trim, crop"))


def check_stft_mel(torch, hann, x) -> dict:
    """Kernel B at the mel frontend's shape ([BATCH, 80000], hann 1024 /
    hop 256: 513 x 313): its max error against the plain version (held in
    `check_stft`'s loop), ms by CUDA events, device ms, the plain version's
    ms and the bytes bound (the signal read once, re and im written once)."""
    from xai_audio_deepfakes_tpu_torch.ops.cuda_stft import stft
    from xai_audio_deepfakes_tpu_torch.ops.stft import stft_plain

    re, im = stft(x, hann)
    re_p, im_p = stft_plain(x, hann)
    err = max(float((re - re_p).abs().max()), float((im - im_p).abs().max()))
    b, n = x.shape
    t = re.shape[-1]
    nbytes = 4 * (b * n + 2 * b * hann.num_bins * t)
    bnd, by = bound_ms(nbytes, b * t * fft_frame_ops(hann.n_fft), "float32")
    row = dict(shape=[b, n], bins_frames=[hann.num_bins, t], window="hann", hop=hann.hop_length,
               max_abs_err=err, ms=time_ms(lambda: stft(x, hann)),
               device_ms=kernel_device_ms(lambda: stft(x, hann), "stft_fft_kernel"),
               plain_ms=time_ms(lambda: stft_plain(x, hann)), bound_ms=bnd, bound_by=by)
    print("B stft at the mel shape: " + json.dumps(row))
    return row


def frontend_lengths(cfg) -> list[int]:
    lengths, n = [], cfg.audio.num_samples
    for k, s in zip(cfg.embedder.conv_kernel, cfg.embedder.conv_stride):
        n = (n - k) // s + 1
        lengths.append(n)
    return lengths


def bf16_steps(torch, got, want):
    """|got - want| in units of one bf16 step (2^-7 of want's power of two)."""
    got, want = got.float(), want.float()
    _, e = torch.frexp(want)
    return (got - want).abs() / torch.ldexp(torch.ones_like(want), e - 8)


def ptxas_entries(report: str, source: str, match: str) -> list[dict]:
    """Registers and spill bytes of the entry functions of `source` whose
    mangled names hold `match`, from the build's ptxas report."""
    import re

    section = report.split(f"== {source}\n", 1)[-1].split("\n== ", 1)[0] if report else ""
    out, entry = [], None
    for line in section.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = dict(entry=m.group(1)) if match in m.group(1) else None
            if entry:
                out.append(entry)
        elif entry is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                entry["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                entry["registers"] = int(m.group(1))
    return out


def check_ln_gelu(torch, cfg, rows: list) -> None:
    import torch.nn.functional as F

    from xai_audio_deepfakes_tpu_torch.ops import _cuda
    from xai_audio_deepfakes_tpu_torch.ops.cuda_ln_gelu import ln_gelu_, ln_gelu_plain

    e = cfg.embedder
    c, eps = e.conv_dim[0], e.layer_norm_eps
    g = torch.Generator(device="cuda").manual_seed(3)
    scale = 1.0 + 0.1 * torch.randn(c, device="cuda", generator=g)
    bias = 0.1 * torch.randn(c, device="cuda", generator=g)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_share = flip_share = 0.0
    # the persistent blocks split the tiles by batch: every batch of the paths
    for b in EMBED_BATCHES:
        for length in frontend_lengths(cfg):
            x32 = torch.randn(b, c, length, device="cuda", generator=g) * 2.0 + 0.5
            for dt, atol, rtol in ((torch.float32, 2e-5, 0.0), (torch.bfloat16, 1e-2, 1e-2)):
                x = x32.to(dt)
                for form in ("exact", "tanh"):
                    out = ln_gelu_(x.clone(), scale, bias, eps, form)
                    torch.cuda.synchronize()
                    want = ln_gelu_plain(x, scale, bias, eps, form)
                    errs[dt] = max(errs[dt], check_close(
                        f"D ln_gelu {dt} {form} batch {b} L={length}", out, want, atol, rtol))
                    if dt == torch.bfloat16:
                        steps = bf16_steps(torch, out, want)
                        share = float((steps > 1).float().mean())
                        worst_share = max(worst_share, share)
                        flip_share = max(flip_share, float((steps > 0).float().mean()))
                        if share > 1e-3:
                            fail(f"D ln_gelu: {share:.2e} of the elements are more than one "
                                 f"bf16 step off (batch {b}, L={length})")
                    del out, want
            del x32, x
    # timed at the UNet explain's batch
    b = EMBED_BATCHES[-1]
    plain = lib = lib_dev = 0.0
    by_layer, dev_by_layer, gbs_by_layer, lib_dev_by_layer = [], [], [], []
    for length in frontend_lengths(cfg):
        x = (torch.randn(b, c, length, device="cuda", generator=g) * 2.0 + 0.5).to(torch.bfloat16)
        work = x.clone()
        by_layer.append(time_ms(lambda: ln_gelu_(work, scale, bias, eps, e.gelu), iters=5))
        dev_by_layer.append(kernel_device_ms(lambda: ln_gelu_(work, scale, bias, eps, e.gelu),
                                             "ln_gelu", 5))
        gbs_by_layer.append(2 * 2 * b * c * length / (dev_by_layer[-1] * 1e-3) / 1e9)
        plain += time_ms(lambda: ln_gelu_plain(x, scale, bias, eps, e.gelu), iters=5)
        xt = x.transpose(1, 2).contiguous()
        def ln_gelu_lib():
            return F.gelu(F.layer_norm(xt, (c,), scale.to(xt.dtype), bias.to(xt.dtype), eps))

        lib += time_ms(ln_gelu_lib, iters=5)
        lib_dev_by_layer.append(kernel_device_ms(ln_gelu_lib, iters=5))
        lib_dev += lib_dev_by_layer[-1]
        del work, xt, x
    elems = b * c * sum(frontend_lengths(cfg))
    ms, dev = sum(by_layer), sum(dev_by_layer)
    # ~16 operations per element (statistics, normalisation, GELU with erf as one)
    bnd, by = bound_ms(2 * 2 * elems, 16 * elems, "float32")
    regs = ptxas_entries(_cuda.build_log.get("ptxas", ""), "ln_gelu.cu", "ln_gelu_kernel")
    print(f"  D by layer: ms {[round(v, 4) for v in by_layer]}, device ms "
          f"{[round(v, 4) for v in dev_by_layer]}, GB/s {[round(v) for v in gbs_by_layer]} "
          f"(peak {HBM_BYTES_PER_S / 1e9:.0f}), library device ms "
          f"{[round(v, 4) for v in lib_dev_by_layer]}; bf16 elements off by any step "
          f"{flip_share:.2e}, by more than one {worst_share:.2e}")
    rows.append(dict(name="ln_gelu", route="cuda", source="xai_audio_deepfakes_tpu_torch/csrc/ln_gelu.cu",
                     replaces="xai_audio_deepfakes_tpu/ops/pallas_ln_gelu.py:113",
                     max_abs_err=errs[torch.bfloat16], ms=ms, plain_ms=plain, bound_ms=bnd,
                     bound_by=by, library_ms=lib, f32_max_abs_err=errs[torch.float32],
                     shape=[b, c, frontend_lengths(cfg)], dtype="bfloat16",
                     kernel_device_ms=dev, library_device_ms=lib_dev,
                     ms_by_layer=by_layer, device_ms_by_layer=dev_by_layer,
                     library_device_ms_by_layer=lib_dev_by_layer,
                     gb_per_s_by_layer=gbs_by_layer,
                     gb_per_s=2 * 2 * elems / (dev * 1e-3) / 1e9,
                     share_over_one_bf16_step=worst_share, share_off_by_any_bf16_step=flip_share,
                     ptxas=regs,
                     body="tiles of all C channels x 64 frames (bf16; 32 for f32), each channel "
                     "row in a shared-memory ring of 16-byte chunks filled by cp.async, read at "
                     "the row's own shift; a block walks a run of consecutive tiles, so a chunk "
                     "two tiles share is copied once and stored once, whole; thread = frame, "
                     "every 8th channel in registers, statistics in the plain version's "
                     "summation order; 16-byte stores but at the ends of a run; persistent "
                     "grid, next tile's copies in flight; GELU form a template constant",
                     note="ms, device ms, plain_ms, library_ms and bound_ms summed over the 7 "
                     "frontend shapes; errors over both GELU forms"))


def conv_inputs(torch, g, dtype, k: int, length: int, batch: int, c: int):
    """Activations ~ N(0, 1), weights ~ N(0, 1 / fan_in), as the frontend's."""
    x = torch.randn(batch, c, length, device="cuda", generator=g)
    w = torch.randn(c, c, k, device="cuda", generator=g) * (c * k) ** -0.5
    cb = 0.1 * torch.randn(c, device="cuda", generator=g)
    scale = 1.0 + 0.1 * torch.randn(c, device="cuda", generator=g)
    bias = 0.1 * torch.randn(c, device="cuda", generator=g)
    return x.to(dtype), w.to(dtype), cb.to(dtype), scale, bias


def check_conv_ln_gelu(torch, cfg, rows: list) -> None:
    import torch.nn.functional as F

    from xai_audio_deepfakes_tpu_torch.ops.cuda_conv import conv_ln_gelu, conv_ln_gelu_plain

    e = cfg.embedder
    c, eps = e.conv_dim[0], e.layer_norm_eps
    g = torch.Generator(device="cuda").manual_seed(4)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    ms = plain = lib = ops = nbytes = dev = lib_dev = 0.0
    by_layer, dev_by_layer, l2_weight_gb = [], [], []
    worst_share = 0.0
    lengths = frontend_lengths(cfg)
    # f32: sums of k * 512 products in another order than cuDNN's, on values
    # of order 1 after the LayerNorm. bf16: the tensor cores' f32 sums differ
    # from cuDNN's in the last bits, so a conv sum now and then rounds to the
    # neighbouring bf16 value; that step (up to 2^-7 of the value) passes
    # through the normalisation's and the GELU's own roundings, up to four
    # bf16 steps in all (4 * 2^-7 = 3.2e-2 of |y|). Such elements are rare:
    # at most 0.1% may differ by more than one step (1e-2 + 1e-2 |y|).
    tolerances = ((torch.float32, 2e-5, 0.0), (torch.bfloat16, 1e-2, 3.2e-2))
    for b in EMBED_BATCHES:
        for layer in range(1, len(lengths)):
            k, l_in, l_out = e.conv_kernel[layer], lengths[layer - 1], lengths[layer]
            for dt, atol, rtol in tolerances:
                x, w, cb, scale, bias = conv_inputs(torch, g, dt, k, l_in, b, c)
                out = conv_ln_gelu(x, w, cb, scale, bias, eps, e.gelu)
                torch.cuda.synchronize()
                if tuple(out.shape) != (b, c, l_out):
                    fail(f"E conv_ln_gelu: output {tuple(out.shape)}, want {(b, c, l_out)}")
                want = conv_ln_gelu_plain(x, w, cb, scale, bias, eps, e.gelu)
                errs[dt] = max(errs[dt], check_close(
                    f"E conv_ln_gelu {dt} batch {b} k={k} L={l_in}", out, want, atol, rtol))
                if dt == torch.bfloat16:
                    off = (out.float() - want.float()).abs() > 1e-2 + 1e-2 * want.float().abs()
                    share = float(off.float().mean())
                    worst_share = max(worst_share, share)
                    print(f"    more than one bf16 step off: {share:.2e} of the elements "
                          "(at most 1e-3)")
                    if share > 1e-3:
                        fail("E conv_ln_gelu: too many elements are more than one bf16 step off")
                del out, want, x, w
    # timed at the UNet explain's batch
    b = EMBED_BATCHES[-1]
    for layer in range(1, len(lengths)):
        k, l_in, l_out = e.conv_kernel[layer], lengths[layer - 1], lengths[layer]
        x, w, cb, scale, bias = conv_inputs(torch, g, torch.bfloat16, k, l_in, b, c)
        by_layer.append(time_ms(lambda: conv_ln_gelu(x, w, cb, scale, bias, eps, e.gelu),
                                iters=5, warmup=1))
        ms += by_layer[-1]
        # every kernel of the call, the wrapper's weight-image copy with E, as
        # the library's device time counts every kernel of its call
        dev_by_layer.append(kernel_device_ms(
            lambda: conv_ln_gelu(x, w, cb, scale, bias, eps, e.gelu), iters=5))
        dev += dev_by_layer[-1]
        plain += time_ms(lambda: conv_ln_gelu_plain(x, w, cb, scale, bias, eps, e.gelu),
                         iters=5, warmup=1)
        sc, bi = scale.to(x.dtype), bias.to(x.dtype)
        def conv_lib():
            return F.gelu(F.layer_norm(F.conv1d(x, w, cb, stride=2).transpose(1, 2), (c,), sc, bi,
                                       eps))

        lib += time_ms(conv_lib, iters=5, warmup=1)
        lib_dev += kernel_device_ms(conv_lib, iters=5)
        # design arithmetic, not a measurement: every block of 64 frames reads
        # all k * c * c bf16 weights from L2
        l2_weight_gb.append(b * math.ceil(l_out / 64) * k * c * c * 2 / 1e9)
        ops += 2.0 * b * l_out * c * c * k
        nbytes += 2.0 * (b * c * (l_in + l_out) + c * c * k) + 4.0 * 3 * c
        del x, w
    print("  E L2 weight GB by layer, derived from the 64-frame tiling (not measured): "
          + json.dumps([round(gb, 3) for gb in l2_weight_gb]))
    bnd, by = bound_ms(nbytes, ops, "bfloat16")
    rows.append(dict(name="conv_ln_gelu", route="cuda",
                     source="xai_audio_deepfakes_tpu_torch/csrc/conv_ln_gelu.cu",
                     replaces="xai_audio_deepfakes_tpu/ops/pallas_conv.py:213",
                     max_abs_err=errs[torch.bfloat16], ms=ms, plain_ms=plain, bound_ms=bnd,
                     bound_by=by, library_ms=lib, f32_max_abs_err=errs[torch.float32],
                     shape=[b, c, lengths[:-1]], dtype="bfloat16", gflop=ops / 1e9, ms_by_layer=by_layer,
                     kernel_device_ms=dev, library_device_ms=lib_dev,
                     device_ms_by_layer=dev_by_layer,
                     body="bf16: wgmma m64n256k16 with both operands in shared memory, 64 "
                     "frames x 512 channels a block, a producer warpgroup fills a 3-5 stage "
                     "ring (weights by bulk copy, even/odd im2col planes from cp.async rows) on "
                     "mbarriers, LayerNorm from the registers; f32: CUDA-core FMAs",
                     share_over_one_bf16_step=worst_share,
                     note="ms, device ms, plain_ms, library_ms and bound_ms summed over "
                     "frontend layers 1-6"))


def check_backwards(torch, cfg) -> None:
    """Backward of each differentiated kernel wrapper (forward through the
    kernel, backward by recomputation) against autograd through the plain
    version, in f32 at the training step's shapes (2 clips). Tolerance: 1e-4
    of the gradient's largest magnitude (f32 sums in another order)."""
    from xai_audio_deepfakes_tpu_torch.ops.attention import attention, attention_plain
    from xai_audio_deepfakes_tpu_torch.ops.cuda_conv import conv_ln_gelu, conv_ln_gelu_plain
    from xai_audio_deepfakes_tpu_torch.ops.cuda_ln_gelu import ln_gelu, ln_gelu_plain
    from xai_audio_deepfakes_tpu_torch.ops.cuda_stft import istft
    from xai_audio_deepfakes_tpu_torch.ops.stft import istft_plain

    e, sc, n = cfg.embedder, cfg.stft, cfg.audio.num_samples
    b, t, nh, c, eps = cfg.train.batch_size, cfg.audio.num_frames(cfg.stft), e.num_heads, 512, 1e-5
    g = torch.Generator(device="cuda").manual_seed(7)
    qkv = []
    for _ in range(3):
        x = torch.zeros(b, t, nh, 128, device="cuda")
        x[..., :120] = torch.randn(b, t, nh, 120, device="cuda", generator=g) * 0.3
        qkv.append(x.reshape(b, t, nh * 128))
    spec = [torch.randn(b, sc.num_bins, t, device="cuda", generator=g) for _ in range(2)]
    length = frontend_lengths(cfg)[0]
    conv = conv_inputs(torch, g, torch.float32, 3, length, b, c)
    cases = (
        ("A attention", qkv, lambda q, k, v: attention(q, k, v, nh),
         lambda q, k, v: attention_plain(q, k, v, nh)),
        ("C istft", spec, lambda re, im: istft(re, im, sc, n),
         lambda re, im: istft_plain(re, im, sc, n)),
        ("D ln_gelu", [conv[0], conv[3], conv[4]],
         lambda x, s, bi: ln_gelu(x * 1.0, s, bi, eps, e.gelu),
         lambda x, s, bi: ln_gelu_plain(x, s, bi, eps, e.gelu)),
        ("E conv_ln_gelu", list(conv), lambda *a: conv_ln_gelu(*a, eps, e.gelu),
         lambda *a: conv_ln_gelu_plain(*a, eps, e.gelu)),
    )

    def grads(fn, tensors):
        leaves = [x.detach().clone().requires_grad_() for x in tensors]
        (fn(*leaves) ** 2).sum().backward()
        return [x.grad for x in leaves]

    for name, tensors, fn, plain in cases:
        for i, (got, want) in enumerate(zip(grads(fn, tensors), grads(plain, tensors))):
            check_close(f"{name} backward, input {i}", got, want,
                        1e-4 * float(want.abs().max()))


def check_backwards_bf16(torch, cfg) -> None:
    """The bf16 gradients of A, D and E at the batch that the attribution
    harness and the training step differentiate (2 clips, the kernel
    launched in the forward). Each backward recomputes from the saved bf16
    inputs: A forms dq, dk and dv in f32 (`attention_backward`), D and E run
    autograd through their plain versions. The reference takes the same
    inputs and the same seeded upstream gradient: autograd through A's plain
    version on the inputs widened to f32 (where its cast points are exact),
    through D's and E's plain versions in bf16. Bar: 1e-4 of the gradient's
    largest magnitude, as in `check_backwards` (f32 sums in another order),
    plus one bf16 step (2^-7 of the value) for the gradient's rounding. The
    forward outputs are held at the forward checks' bars."""
    from xai_audio_deepfakes_tpu_torch.ops.attention import attention, attention_plain
    from xai_audio_deepfakes_tpu_torch.ops.cuda_conv import conv_ln_gelu, conv_ln_gelu_plain
    from xai_audio_deepfakes_tpu_torch.ops.cuda_ln_gelu import ln_gelu, ln_gelu_plain

    e, bf16 = cfg.embedder, torch.bfloat16
    b, t = cfg.train.batch_size, cfg.audio.num_frames(cfg.stft)
    nh, eps = e.num_heads, e.layer_norm_eps
    lengths = frontend_lengths(cfg)
    g = torch.Generator(device="cuda").manual_seed(8)
    qkv = [x.to(bf16) for x in attention_inputs(torch, g, b, t, nh, 120, 128, q_scale=120**-0.5)]
    x0 = (torch.randn(b, e.conv_dim[0], lengths[0], device="cuda", generator=g) * 2.0
          + 0.5).to(bf16)
    ln_affine = [1.0 + 0.1 * torch.randn(e.conv_dim[0], device="cuda", generator=g),
                 0.1 * torch.randn(e.conv_dim[0], device="cuda", generator=g)]
    conv = list(conv_inputs(torch, g, bf16, e.conv_kernel[1], lengths[0], b, e.conv_dim[0]))
    cases = (  # name, inputs, kernel route, reference, forward rtol, widen to f32
        ("A attention", qkv, lambda q, k, v: attention(q, k, v, nh),
         lambda q, k, v: attention_plain(q, k, v, nh), 1e-2, True),
        ("D ln_gelu", [x0, *ln_affine], lambda x, s, bi: ln_gelu(x, s, bi, eps, e.gelu),
         lambda x, s, bi: ln_gelu_plain(x, s, bi, eps, e.gelu), 1e-2, False),
        ("E conv_ln_gelu", conv, lambda *a: conv_ln_gelu(*a, eps, e.gelu),
         lambda *a: conv_ln_gelu_plain(*a, eps, e.gelu), 3.2e-2, False),
    )
    for name, tensors, fn, plain, fwd_rtol, widen in cases:
        leaves = [x.detach().clone().requires_grad_() for x in tensors]
        out = fn(*leaves)
        gy = torch.randn(out.shape, device="cuda", generator=g).to(out.dtype)
        got = torch.autograd.grad(out, leaves, gy)
        ref_leaves = [(x.float() if widen else x).detach().clone().requires_grad_()
                      for x in tensors]
        ref_out = plain(*ref_leaves)
        want = torch.autograd.grad(ref_out, ref_leaves, gy.to(ref_out.dtype))
        check_close(f"{name} bf16 forward under autograd, batch {b}", out.detach(),
                    ref_out.detach().to(out.dtype), 1e-2, fwd_rtol)
        for i, (gi, wi) in enumerate(zip(got, want)):
            if gi.dtype != tensors[i].dtype:
                fail(f"{name} bf16 backward: input {i}'s gradient is {gi.dtype}")
            check_close(f"{name} bf16 backward, batch {b}, input {i}", gi.float(), wi.float(),
                        1e-4 * float(wi.abs().max()), 2.0**-7)


def embedder_split(torch, pipe, wavs, prefix: str) -> dict:
    """Device ms of the embedder's stages on the clips `wavs` (CUDA events,
    5 calls): frontend, projection + positional conv, and the transformer
    layers (with the calibrated scales under int8-static)."""
    from xai_audio_deepfakes_tpu_torch.ops.normalize import zero_mean_unit_var_norm

    enc, cfg = pipe.encoder, pipe.cfg
    static = cfg.embedder.quant == "int8-static" and pipe.quant_scales is not None
    with torch.inference_mode():
        norm = zero_mean_unit_var_norm(wavs)
        fe = enc.feature_encoder(norm)
        proj = enc.feature_projection(fe)
        x = proj + enc.pos_conv(proj)

        def layers():
            y = x
            for i, layer in enumerate(enc.layers):
                y = layer(y, {k: v[i] for k, v in pipe.quant_scales.items()} if static else None)

        return {
            f"{prefix}frontend": time_ms(lambda: enc.feature_encoder(norm), iters=5),
            f"{prefix}projection + pos conv": time_ms(
                lambda: proj + enc.pos_conv(enc.feature_projection(fe)), iters=5),
            f"{prefix}{len(enc.layers)} layers": time_ms(layers, iters=5),
        }


def stage_split(torch, pipe, wav) -> dict:
    """Device ms of each stage of one explain on its own (CUDA events, 5
    calls after a warm-up): spectrogram, predict_mask, masking and the two
    iSTFTs, and the 3B-batch embedder by `embedder_split`."""
    from xai_audio_deepfakes_tpu_torch.ops.masking import apply_mask, remask_complex

    cfg = pipe.cfg
    with torch.inference_mode():
        out = pipe.explain(wav)
        _, _, mag, phase = pipe.spectrogram(wav)

        def masked_istfts():
            rel, irr = apply_mask(out.mask, mag, cfg.masking)
            pipe.istft(*remask_complex(rel, phase))
            pipe.istft(*remask_complex(irr, phase))

        unet = f"predict_mask (UNet {cfg.unet.dtype}{', int8' if cfg.unet.quant != 'none' else ''})"
        return {
            "spectrogram": time_ms(lambda: pipe.spectrogram(wav), iters=5),
            unet: time_ms(lambda: pipe.predict_mask(mag), iters=5),
            "masking + 2 iSTFT": time_ms(masked_istfts, iters=5),
            **embedder_split(torch, pipe, torch.cat([wav, out.relevant_wav, out.irrelevant_wav]),
                             "embedder: "),
        }


def stage_split_features(torch, pipe, wav) -> dict:
    """Device ms of each stage of one feature-decoder explain on its own
    (CUDA events, 5 calls after a warm-up): spectrogram, the clean embed at
    batch B, the feature decoder, masking and the two iSTFTs, and the
    2B-batch embed of the masked clips with the LogReg head; then both
    embeds by `embedder_split`."""
    from xai_audio_deepfakes_tpu_torch.ops.masking import apply_mask, remask_complex

    cfg = pipe.cfg
    with torch.inference_mode():
        out = pipe.explain(wav, decoder="features")
        _, _, mag, phase = pipe.spectrogram(wav)
        feats = pipe.features(wav)
        both = torch.cat([out.relevant_wav, out.irrelevant_wav])

        def masked_istfts():
            rel, irr = apply_mask(out.mask, mag, cfg.masking)
            pipe.istft(*remask_complex(rel, phase))
            pipe.istft(*remask_complex(irr, phase))

        return {
            "spectrogram": time_ms(lambda: pipe.spectrogram(wav), iters=5),
            "embed clean (B)": time_ms(lambda: pipe.features(wav), iters=5),
            f"feature decoder ({cfg.feat_decoder.dtype})": time_ms(
                lambda: pipe.predict_mask_from_features(feats, mag), iters=5),
            "masking + 2 iSTFT": time_ms(masked_istfts, iters=5),
            "embed relevant + irrelevant (2B) + LogReg": time_ms(lambda: pipe.classify(both),
                                                                  iters=5),
            **embedder_split(torch, pipe, wav, "clean embed (B): "),
            **embedder_split(torch, pipe, both, "2B embed: "),
        }


def build_pipeline(torch, cfg, seed: int = 0):
    from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline

    t0 = time.perf_counter()
    pipe = ADDvisorPipeline(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    print(f"pipeline built with random weights in {time.perf_counter() - t0:.1f} s")
    return pipe


def launches_of(a: int = 0, b: int = 0, c: int = 0, d: int = 0, e: int = 0) -> dict:
    return {"attention": a, "stft": b, "istft": c, "ln_gelu": d, "conv_ln_gelu": e}


def run_explain(torch, cfg, want: dict, reps: int, name: str = "", split: bool = False,
                decoder: str = "unet", pipe=None):
    """One counted explain at full width and `reps` timed ones; returns the
    launch counts and the three probabilities of every clip. Under
    int8-static the pipeline is first calibrated on 16 seeded clips; with
    `split` the stage split of `stage_split` (or, with the feature decoder,
    `stage_split_features`) is printed."""
    import numpy as np

    from xai_audio_deepfakes_tpu_torch.ops import _cuda

    pipe = pipe or build_pipeline(torch, cfg)
    if cfg.embedder.quant == "int8-static":
        calib = np.random.default_rng(2).standard_normal((16, cfg.audio.num_samples)) * 0.1
        calib = torch.from_numpy(calib.astype(np.float32)).cuda()
        pipe.calibrate_quant(calib)  # warm-up: the first call also quantizes the weights
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scales = pipe.calibrate_quant(calib)
        torch.cuda.synchronize()
        print(f"calibrate_quant on 16 clips (one batch of 16, p999): "
              f"{time.perf_counter() - t0:.3f} s; scales "
              + ", ".join(f"{k} {list(v.shape)}" for k, v in scales.items()))
        # the head-padded context's pad lanes are zeros: their scales are 0
        if not all(bool(torch.isfinite(v).all() and (v >= 0).all()) for v in scales.values()):
            fail("calibrate_quant gave a scale that is negative or not finite")
    wav = np.random.default_rng(0).standard_normal((BATCH, cfg.audio.num_samples)).astype(np.float32) * 0.1
    wav_t = torch.from_numpy(wav).cuda()
    pipe.explain(wav_t, decoder=decoder)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _cuda.reset_launches()
    t0 = time.perf_counter()
    out = pipe.explain(wav_t, decoder=decoder)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    print(f"explain launches: {launches}")
    if launches != want:
        fail(f"launch counts {launches} != {want}")

    n, f, t = cfg.audio.num_samples, cfg.stft.num_bins, cfg.audio.num_frames(cfg.stft)
    shapes = dict(mask=(BATCH, f, t), magnitude=(BATCH, f, t), phase=(BATCH, f, t),
                  relevant_wav=(BATCH, n), irrelevant_wav=(BATCH, n), probs_clean=(BATCH, 1),
                  probs_relevant=(BATCH, 1), probs_irrelevant=(BATCH, 1))
    for key, shape in shapes.items():
        v = getattr(out, key)
        if tuple(v.shape) != shape or not bool(torch.isfinite(v).all()):
            fail(f"explain.{key}: shape {tuple(v.shape)} (want {shape}) or non-finite")
    for key in ("probs_clean", "probs_relevant", "probs_irrelevant"):
        p = getattr(out, key)
        if not bool(((p > 0) & (p < 1)).all()):
            fail(f"explain.{key} outside (0, 1): {p.flatten().tolist()}")
    print("probs_clean", [round(v, 4) for v in out.probs_clean.flatten().tolist()])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        pipe.explain(wav_t, decoder=decoder)
    torch.cuda.synchronize()
    steady = (time.perf_counter() - t0) / reps
    e, u = cfg.embedder, cfg.unet
    name = name or f"fused_conv={e.fused_conv}"
    mask_decoder = f"UNet {u.dtype}" if decoder == "unet" else (
        f"feature decoder {cfg.feat_decoder.dtype}")
    print(f"explain B={BATCH} {name} (embedder {e.dtype}, quant {e.quant}, gelu {e.gelu}, "
          f"fused_ln_gelu {e.fused_ln_gelu}, fused_conv {e.fused_conv}; {mask_decoder}): "
          f"counted run {first * 1e3:.1f} ms, steady {steady * 1e3:.1f} ms, "
          f"{BATCH / steady:.2f} clips/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if split:
        fn = stage_split if decoder == "unet" else stage_split_features
        print(f"  stage split ({name}), device ms: " + json.dumps(
            {k: round(v, 3) for k, v in fn(torch, pipe, wav_t).items()}))
    probs = torch.cat([out.probs_clean, out.probs_relevant, out.probs_irrelevant])
    return launches, probs.flatten().cpu()


TINY_REPEATS = 20  # card explains held against one CPU explain (the mask miss, ROADMAP Queue 3)


def run_tiny_reference(torch, repeats: int = TINY_REPEATS) -> None:
    """Tiny f32 explain on the card, `repeats` times, against the same
    weights on the CPU: every run at the bars; the largest deviation of each
    output over the runs is printed, and how many runs' masks were bit for
    bit the first's."""
    from xai_audio_deepfakes_tpu_torch.config import (
        AudioConfig,
        EmbedderConfig,
        PipelineConfig,
        UNetConfig,
    )
    from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline

    cfg = PipelineConfig(audio=AudioConfig(clip_seconds=0.5), embedder=EmbedderConfig.tiny(),
                         unet=UNetConfig(freq_bins=64, frames=24, base_channels=4))
    gpu = ADDvisorPipeline(cfg, device="cuda", seed=5)
    cpu = ADDvisorPipeline(cfg, device="cpu", seed=5)
    cpu.encoder.load_state_dict(gpu.encoder.state_dict())
    cpu.unet.load_state_dict(gpu.unet.state_dict())
    cpu.logreg = {k: v.cpu() for k, v in gpu.logreg.items()}
    g = torch.Generator().manual_seed(6)
    wav = torch.randn(2, cfg.audio.num_samples, generator=g) * 0.1
    out_cpu = cpu.explain(wav)
    bars = (("mask", 1e-5), ("relevant_wav", 2e-4), ("irrelevant_wav", 2e-4),
            ("probs_clean", 1e-4), ("probs_relevant", 1e-4), ("probs_irrelevant", 1e-4))
    worst, first_mask, same = dict.fromkeys(dict(bars), 0.0), None, 0
    for _ in range(repeats):
        out_gpu = gpu.explain(wav.cuda())
        torch.cuda.synchronize()
        for name, atol in bars:
            got, want = getattr(out_gpu, name).cpu(), getattr(out_cpu, name)
            err = float((got - want).abs().max())
            worst[name] = max(worst[name], err)
            if not err <= atol:
                check_close(f"tiny explain {name}", got, want, atol)  # prints and fails
        mask = out_gpu.mask.cpu()
        first_mask = mask if first_mask is None else first_mask
        same += bool(torch.equal(mask, first_mask))
    print(f"tiny explain x{repeats} on the card vs the CPU, largest deviations: "
          + ", ".join(f"{k} {v:.3e} (bar {dict(bars)[k]:g})" for k, v in worst.items())
          + f"; masks bit for bit the first run's: {same} of {repeats}")


def run_training(torch, cfg) -> tuple[dict, float]:
    """LMAC training steps of the UNet decoder at full width and depth on
    seeded noise; returns the launches of the counted steps together and
    the steady step ms."""
    import numpy as np

    from xai_audio_deepfakes_tpu_torch.ops import _cuda
    from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline
    from xai_audio_deepfakes_tpu_torch.train.train_addvisor import init_train_state, make_train_step

    e, b = cfg.embedder, cfg.train.batch_size
    pipe = ADDvisorPipeline(cfg, device="cuda", seed=0)
    state = init_train_state(pipe)
    events: list = []

    def mark(name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    step = make_train_step(pipe, mark=mark)
    rng = np.random.default_rng(1)
    enc_before = [p.detach().clone() for p in pipe.encoder.parameters()]
    dec_before = [p.detach().clone() for p in pipe.unet.parameters()]
    fusable = sum(blk.fusable for blk in pipe.encoder.feature_encoder.conv_layers)
    want = {"attention": 3 * e.num_layers, "stft": 1, "istft": 2,
            "ln_gelu": 3 * (len(e.conv_dim) - fusable), "conv_ln_gelu": 3 * fusable}
    total = dict.fromkeys(want, 0)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(3 + 3):  # three counted and asserted steps, then three timed ones
        wav = (rng.standard_normal((b, cfg.audio.num_samples)) * 0.1).astype(np.float32)
        _cuda.reset_launches()
        events.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        _, aux = step(state, wav)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(_cuda.LAUNCHES)
        if launches != want:
            fail(f"training step {i}: launch counts {launches} != {want}")
        vec = aux["loss_vec"].cpu()
        if not bool(torch.isfinite(vec).all()):
            fail(f"training step {i}: non-finite losses {vec.tolist()}")
        w_sum = float(aux["w"].sum())
        if abs(w_sum - 3.0) > 1e-4:
            fail(f"training step {i}: softplus(w_raw) sums to {w_sum}, not 3")
        if i < 3:
            for name in total:
                total[name] += launches[name]
        print(f"  step {i}: loss {vec[0]:.5f} l_in {vec[1]:.5f} l_out {vec[2]:.5f} l1 {vec[3]:.5f} "
              f"w {[round(v, 5) for v in aux['w'].tolist()]} {times[-1]:.1f} ms")
    print(f"training launches per step: {want}")
    if not all(torch.equal(a, p) for a, p in zip(enc_before, pipe.encoder.parameters())):
        fail("training changed an embedder parameter")
    if not any(not torch.equal(a, p) for a, p in zip(dec_before, pipe.unet.parameters())):
        fail("training changed no decoder parameter")
    split, prev = {}, start
    for name, ev in events:  # of the last step
        split[name] = prev.elapsed_time(ev)
        prev = ev
    print(f"training step B={b} (bf16 embedder, fused_ln_gelu, fused_conv, f32 UNet): steady "
          f"{sum(times[3:]) / 3:.1f} ms (first {times[0]:.1f} ms), last step's device split "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items())
          + f", peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return total, sum(times[3:]) / 3


def rel_l2(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float((a - b).norm() / b.norm())


def check_bf16_bars(name: str, got, want, want_f32) -> None:
    """The bf16 bars of `tests/test_torch_bf16.py`: mean |got - want| at most
    0.4x mean |want - want_f32| (the same configuration's own bf16-vs-f32
    deviation), max at most max(that deviation's max, two bf16 steps at
    max |want|)."""
    import torch

    got, want, want_f32 = got.float().cpu(), want.float().cpu(), want_f32.float().cpu()
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite output")
    err, own = (got - want).abs(), (want - want_f32).abs()
    two_steps = 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 6)
    bar_max = max(float(own.max()), two_steps)
    ok = float(err.mean()) <= 0.4 * float(own.mean()) and float(err.max()) <= bar_max
    print(f"  {name}: mean_abs_err {float(err.mean()):.3e} (bar {0.4 * float(own.mean()):.3e}), "
          f"max_abs_err {float(err.max()):.3e} (bar {bar_max:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name}: the card and the CPU disagree beyond the bf16 bars")


def run_tiny_configs(torch) -> None:
    """A tiny explain of each configuration this slice added, on the card
    against the port on the CPU with the same weights (and, for int8-static,
    the scales calibrated on the card). The reference for each bar is the
    same configuration's own distance from the f32, unquantized port on the
    CPU: bf16 outputs at the bf16 bars (`check_bf16_bars`), int8
    probabilities at relative L2 <= 1/10 of the int8-vs-f32 relative L2,
    f32 UNet masks at 1e-5 and their waveforms at 2e-4. The int32 products
    are exact on both devices; the gap is the float arithmetic around them
    (cuBLAS / cuDNN sum orders in bf16 against the CPU's), which moves a
    bf16 rounding, and through it now and then a quantization step."""
    from xai_audio_deepfakes_tpu_torch.config import (
        AudioConfig,
        EmbedderConfig,
        PipelineConfig,
        UNetConfig,
    )
    from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline

    tiny_unet = dict(freq_bins=64, frames=24, base_channels=4)
    cases = {
        "entry config (bf16 embedder)": (dict(dtype="bfloat16"), {}),
        "bench default (bf16, int8, tanh, bf16 UNet)": (
            dict(dtype="bfloat16", quant="int8", gelu="tanh"), dict(dtype="bfloat16")),
        "bench int8-static": (dict(dtype="bfloat16", quant="int8-static", gelu="tanh"),
                              dict(dtype="bfloat16")),
        "quant_conv + UNet int8": (dict(dtype="bfloat16", quant="int8", quant_conv="int8",
                                        conv_dim=(128, 128, 128)), dict(quant="int8")),
        "fused_attention=False": (dict(dtype="bfloat16", fused_attention=False), {}),
    }
    g = torch.Generator().manual_seed(6)
    wav = torch.randn(2, 8000, generator=g) * 0.1
    calib = torch.randn(4, 8000, generator=g) * 0.1
    names = ("probs_clean", "probs_relevant", "probs_irrelevant")
    for case, (emb, unet) in cases.items():
        cfg = PipelineConfig(audio=AudioConfig(clip_seconds=0.5),
                             embedder=dataclasses.replace(EmbedderConfig.tiny(), **emb),
                             unet=UNetConfig(**tiny_unet, **unet))
        plain = cfg.replace(embedder=dataclasses.replace(cfg.embedder, dtype="float32",
                                                         quant="none", quant_conv="none"),
                            unet=UNetConfig(**tiny_unet))
        gpu = ADDvisorPipeline(cfg, device="cuda", seed=5)
        pipes = [gpu, ADDvisorPipeline(cfg, device="cpu", seed=5),
                 ADDvisorPipeline(plain, device="cpu", seed=5)]
        for pipe in pipes[1:]:
            pipe.encoder.load_state_dict(gpu.encoder.state_dict())
            pipe.unet.load_state_dict(gpu.unet.state_dict())
            pipe.logreg = {k: v.cpu() for k, v in gpu.logreg.items()}
        if cfg.embedder.quant == "int8-static":
            scales = gpu.calibrate_quant(calib.cuda(), batch_size=2)
            pipes[1].quant_scales = {k: v.cpu() for k, v in scales.items()}
        out_g, out_c, out_f = (p.explain(wav.cuda() if p is gpu else wav) for p in pipes)
        torch.cuda.synchronize()
        print(f"tiny explain, {case}, card vs CPU:")
        probs = [torch.cat([getattr(o, n).cpu() for n in names]) for o in (out_g, out_c, out_f)]
        if cfg.embedder.quant != "none":
            err, own = rel_l2(probs[0], probs[1]), rel_l2(probs[1], probs[2])
            ok = err <= 0.1 * own
            print(f"  probabilities: rel_l2 {err:.3e} (bar {0.1 * own:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"tiny explain {case}: probabilities disagree beyond the int8 bar")
        else:
            check_bf16_bars("probabilities", probs[0], probs[1], probs[2])
        for key in ("mask", "relevant_wav", "irrelevant_wav"):
            got, want = getattr(out_g, key).cpu(), getattr(out_c, key)
            if cfg.unet.dtype == "float32" and cfg.unet.quant == "none":
                check_close(f"{key}", got, want, 1e-5 if key == "mask" else 2e-4)
            elif cfg.unet.quant != "none":
                err, own = rel_l2(got, want), rel_l2(want, getattr(out_f, key))
                ok = err <= 0.1 * own
                print(f"  {key}: rel_l2 {err:.3e} (bar {0.1 * own:.3e}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"tiny explain {case}: {key} disagrees beyond the int8 bar")
            else:
                check_bf16_bars(key, got, want, getattr(out_f, key))


def frontend_bias_adds(torch, cfg) -> None:
    """The cost of the frontend's separate bf16 bias add (the bias cast point
    of flax's `nn.Conv(dtype=bf16)`): `y + b` over each layer's [3B, 512, L]
    bf16 conv output, CUDA events, summed over the seven layers."""
    g = torch.Generator(device="cuda").manual_seed(3)
    per_layer = []
    with torch.inference_mode():
        for length in frontend_lengths(cfg):
            y = torch.randn(3 * BATCH, 512, length, device="cuda", generator=g).to(torch.bfloat16)
            b = torch.randn(512, device="cuda", generator=g).to(torch.bfloat16)
            per_layer.append(time_ms(lambda: y + b[:, None]))
            del y
    print(f"frontend bias adds (bf16, batch {3 * BATCH}), ms per layer "
          f"{[round(v, 4) for v in per_layer]}, {sum(per_layer):.4f} ms per explain")


def run_tiny_training(torch) -> None:
    """One tiny f32 training step on the card against the same step on the
    CPU: conv widths of 128, so that kernel E runs, and both fused frontend
    switches on."""
    import dataclasses

    from xai_audio_deepfakes_tpu_torch.config import (
        AudioConfig,
        EmbedderConfig,
        PipelineConfig,
        UNetConfig,
    )
    from xai_audio_deepfakes_tpu_torch.ops import _cuda
    from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline
    from xai_audio_deepfakes_tpu_torch.train.train_addvisor import init_train_state, make_train_step

    emb = dataclasses.replace(EmbedderConfig.tiny(), conv_dim=(128, 128, 128), fused_conv=True,
                              fused_ln_gelu=True)
    cfg = PipelineConfig(audio=AudioConfig(clip_seconds=0.5), embedder=emb,
                         unet=UNetConfig(freq_bins=64, frames=24, base_channels=4))
    gpu = ADDvisorPipeline(cfg, device="cuda", seed=5)
    cpu = ADDvisorPipeline(cfg, device="cpu", seed=5)
    cpu.encoder.load_state_dict(gpu.encoder.state_dict())
    cpu.unet.load_state_dict(gpu.unet.state_dict())
    cpu.logreg = {k: v.cpu() for k, v in gpu.logreg.items()}
    wav = torch.randn(2, cfg.audio.num_samples, generator=torch.Generator().manual_seed(8)) * 0.1
    results = []
    _cuda.reset_launches()
    for pipe in (gpu, cpu):
        state = init_train_state(pipe)
        _, aux = make_train_step(pipe)(state, wav)
        results.append((aux, [p.grad.cpu() for p in pipe.unet.parameters()], state.w_raw.detach().cpu()))
    launches = dict(_cuda.LAUNCHES)  # the CPU step launches nothing
    want = {"attention": 3 * len(gpu.encoder.layers), "stft": 1, "istft": 2, "ln_gelu": 3,
            "conv_ln_gelu": 6}
    if launches != want:
        fail(f"tiny training step: launch counts {launches} != {want}")
    (aux_g, grads_g, w_g), (aux_c, grads_c, w_c) = results
    check_close("tiny train losses", aux_g["loss_vec"].cpu(), aux_c["loss_vec"], 1e-4)
    flat_g, flat_c = (torch.cat([g.flatten() for g in gs]) for gs in (grads_g, grads_c))
    check_close("tiny train decoder gradients", flat_g, flat_c, 1e-3 * float(flat_c.abs().max()))
    check_close("tiny train w_raw", w_g, w_c, 1e-5)


def lmac_summary_f64(p, rel, irr) -> dict:
    """The five LMAC metrics' means over all clips, in float64 numpy: the
    plain reference of the harness's device fold."""
    import numpy as np

    p, rel, irr = (np.asarray(a, np.float64).ravel() for a in (p, rel, irr))
    pc, oc = (np.where(x > 0.5, x, 1.0 - x) for x in (p, rel))
    return {
        "faithfulness": float(np.mean((p - irr) * np.sign(p - 0.5))),
        "fidelity": float(np.mean((p > 0.5) == (rel > 0.5))),
        "average_drop": float(np.mean(np.maximum(pc - oc, 0.0) / (pc + 1e-10) * 100.0)),
        "average_increase": float(np.mean((oc > pc) * 100.0)),
        "average_gain": float(np.mean(np.maximum(oc - pc, 0.0) / (1.0 - pc + 1e-10) * 100.0)),
    }


def run_eval(torch, pipe, decoder: str, per_explain: dict) -> dict:
    """`run_explanation_metrics` over 3 batches of BATCH seeded clips; the
    device fold must equal `lmac_summary_f64` over the concatenated
    probabilities (each batch explained again) within 1e-5, relative
    above 1. Returns the sweep's launches (3 explains')."""
    import numpy as np

    from xai_audio_deepfakes_tpu_torch.metrics.harness import run_explanation_metrics
    from xai_audio_deepfakes_tpu_torch.ops import _cuda

    rng = np.random.default_rng(3)
    n = pipe.cfg.audio.num_samples
    batches = [(rng.standard_normal((BATCH, n)) * 0.1).astype(np.float32) for _ in range(3)]
    _cuda.reset_launches()
    t0 = time.perf_counter()
    result = run_explanation_metrics(pipe, batches, decoder=decoder)
    seconds = time.perf_counter() - t0  # the fold's host copy waits for the device
    launches = dict(_cuda.LAUNCHES)
    want = {k: 3 * v for k, v in per_explain.items()}
    print(f"eval harness, decoder={decoder}, 3 batches of {BATCH}: {seconds * 1e3:.1f} ms, "
          f"launches {launches}, result {json.dumps(result)}")
    if launches != want:
        fail(f"eval harness ({decoder}): launch counts {launches} != {want}")
    cols = []
    with torch.inference_mode():
        for wav in batches:
            out = pipe.explain(wav, decoder=decoder)
            cols.append([getattr(out, k).double().cpu().numpy() for k in
                         ("probs_clean", "probs_relevant", "probs_irrelevant")])
    ref = lmac_summary_f64(*(np.concatenate([c[i] for c in cols]) for i in range(3)))
    if result["num_clips"] != 3 * BATCH:
        fail(f"eval harness ({decoder}): num_clips {result['num_clips']}")
    for key, want_v in ref.items():
        err = abs(result[key] - want_v)
        bar = 1e-5 * max(1.0, abs(want_v))
        print(f"  {key}: device fold {result[key]!r}, float64 {want_v!r}, |diff| {err:.2e} "
              f"(bar {bar:.1e}) {'ok' if err <= bar else 'FAIL'}")
        if not err <= bar:
            fail(f"eval harness ({decoder}): {key} disagrees with the float64 summary")
    return launches


ATTRIBUTION_CASES = {  # method: (keyword arguments, gradient evaluations)
    "saliency": ({}, 1),
    "input_x_gradient": ({}, 1),
    "integrated_gradients": ({"steps": 8}, 8),
    "smoothgrad": ({"samples": 4}, 4),
    "gradient_shap": ({"samples": 4}, 4),
}


def run_attribution(torch, pipe) -> dict:
    """Each attribution method through `run_attribution_metrics` on one
    batch of 2 seeded clips at full width; per method the ms, the launches
    (A n_layers and D n_conv per embedder forward: one per gradient
    evaluation and three `classify` calls) and a finite, non-zero map.
    Returns {path: launches}."""
    import numpy as np

    from xai_audio_deepfakes_tpu_torch.metrics.harness import run_attribution_metrics
    from xai_audio_deepfakes_tpu_torch.ops import _cuda

    e = pipe.cfg.embedder
    wav = (np.random.default_rng(5).standard_normal((2, pipe.cfg.audio.num_samples))
           * 0.1).astype(np.float32)
    run_attribution_metrics(pipe, [wav], method="saliency")  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paths = {}
    for method, (kw, evals) in ATTRIBUTION_CASES.items():
        seen = []
        _cuda.reset_launches()
        t0 = time.perf_counter()
        result = run_attribution_metrics(pipe, [wav], method=method,
                                         artifact_fn=lambda *a: seen.append(a), **kw)
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_cuda.LAUNCHES)
        forwards = evals + 3
        want = launches_of(a=e.num_layers * forwards, d=len(e.conv_dim) * forwards)
        mask = torch.from_numpy(seen[0][1])
        print(f"attribution {method} {kw} at batch 2: {ms:.1f} ms, launches {launches}, "
              f"mask max {float(mask.max()):.3f}, result {json.dumps(result)}")
        if launches != want:
            fail(f"attribution {method}: launch counts {launches} != {want}")
        if not bool(torch.isfinite(mask).all()) or not float(mask.abs().max()) > 0:
            fail(f"attribution {method}: the map is not finite or is zero")
        paths[f"attribution_{method}"] = launches
    print(f"attribution peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check_attribution_reproducible(torch, pipe, wav)
    return paths


def run_int8_attribution(torch, cfg) -> dict:
    """Saliency through `run_attribution_metrics` on `bench.py`'s default
    (int8 embedder) at batch 2: a finite, non-zero map, launches A 9 per
    embedder forward (one gradient evaluation and three `classify` calls),
    ms. Returns {path: launches}."""
    import numpy as np

    from xai_audio_deepfakes_tpu_torch.metrics.harness import run_attribution_metrics
    from xai_audio_deepfakes_tpu_torch.ops import _cuda

    pipe = build_pipeline(torch, cfg)
    wav = (np.random.default_rng(5).standard_normal((2, cfg.audio.num_samples))
           * 0.1).astype(np.float32)
    run_attribution_metrics(pipe, [wav], method="saliency")  # warm-up
    torch.cuda.synchronize()
    seen = []
    _cuda.reset_launches()
    t0 = time.perf_counter()
    result = run_attribution_metrics(pipe, [wav], method="saliency",
                                     artifact_fn=lambda *a: seen.append(a))
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_cuda.LAUNCHES)
    mask = torch.from_numpy(seen[0][1])
    print(f"attribution saliency through bench.py's int8 embedder at batch 2: {ms:.1f} ms, "
          f"launches {launches}, mask max {float(mask.max()):.3f}, result {json.dumps(result)}")
    if launches != launches_of(a=cfg.embedder.num_layers * 4):
        fail(f"int8 attribution: launch counts {launches}")
    if not bool(torch.isfinite(mask).all()) or not float(mask.abs().max()) > 0:
        fail("int8 attribution: the map is not finite or is zero")
    del pipe
    torch.cuda.empty_cache()
    return {"attribution_saliency_int8": launches}


def check_attribution_reproducible(torch, pipe, wav) -> None:
    """The harness's saliency map twice: equal bit for bit, since its
    gradients take cuDNN's deterministic algorithms. The same gradient
    twice with cuDNN's default algorithms is printed beside it (measured,
    no bar): how far two runs may drift without that."""
    from xai_audio_deepfakes_tpu_torch.attrib.methods import saliency
    from xai_audio_deepfakes_tpu_torch.metrics.harness import run_attribution_metrics
    from xai_audio_deepfakes_tpu_torch.models.logreg import logreg_apply

    maps = []
    for _ in range(2):
        run_attribution_metrics(pipe, [wav], method="saliency",
                                artifact_fn=lambda *a: maps.append(a[1]))
    same = bool((maps[0] == maps[1]).all())
    print(f"attribution saliency twice through the harness: maps bit for bit "
          f"{'equal' if same else 'DIFFERENT'}")
    if not same:
        fail("attribution: two identical sweeps gave different maps")
    x = pipe._as_input(wav)

    def score(w):
        return logreg_apply(pipe.logreg, pipe.embed(w).mean(dim=1))[0]

    if torch.backends.cudnn.deterministic:
        fail("cuDNN's deterministic algorithms are still on after the harness")
    grads = [saliency(score, x) for _ in range(2)]
    spread = float((grads[0] - grads[1]).abs().max()) / float(grads[1].abs().max())
    print(f"attribution saliency twice with cuDNN's default algorithms: the maps differ by "
          f"{spread:.3e} of their largest magnitude (measured, no bar)")


def hf_state_dict(torch, enc, seed: int) -> dict:
    """A port encoder's weights as a HF `Wav2Vec2Model` checkpoint (numpy
    f32, every key under the `wav2vec2.` prefix): the inverse of
    `params_from_hf_state_dict` + `convert.load_encoder`, with the q/k/v/out
    head padding removed and the positional conv in weight-norm form
    (`weight_g` seeded away from |v|, `weight_v` the weight)."""
    import numpy as np

    from xai_audio_deepfakes_tpu_torch.models.wav2vec2 import HeadDense

    def a(t):  # a copy: the source's parameters change after the export
        return np.array(t.detach().float().cpu().numpy())

    def dense(d):
        w, b = d.weight, d.bias
        if isinstance(d, HeadDense) and d.pad_axis == 1:
            w = w.view(d.nh, d.hdp, -1)[:, :d.hd].reshape(d.nh * d.hd, -1)
            b = b.view(d.nh, d.hdp)[:, :d.hd].reshape(-1)
        elif isinstance(d, HeadDense):
            w = w.view(w.shape[0], d.nh, d.hdp)[:, :, :d.hd].reshape(w.shape[0], -1)
        return a(w), a(b)

    sd = {}

    def put(prefix, weight, bias):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = weight, bias

    for i, blk in enumerate(enc.feature_encoder.conv_layers):
        pre = f"feature_extractor.conv_layers.{i}"
        sd[f"{pre}.conv.weight"] = a(blk.conv.weight)
        if blk.conv.bias is not None:
            sd[f"{pre}.conv.bias"] = a(blk.conv.bias)
        put(f"{pre}.layer_norm", a(blk.layer_norm.weight), a(blk.layer_norm.bias))
    fp = enc.feature_projection
    put("feature_projection.layer_norm", a(fp.layer_norm.weight), a(fp.layer_norm.bias))
    put("feature_projection.projection", *dense(fp.projection))
    pc = enc.pos_conv.conv
    k = pc.weight.shape[-1]
    sd["encoder.pos_conv_embed.conv.weight_g"] = (
        np.random.default_rng(seed).uniform(0.5, 1.5, (1, 1, k)).astype(np.float32))
    sd["encoder.pos_conv_embed.conv.weight_v"] = a(pc.weight)
    sd["encoder.pos_conv_embed.conv.bias"] = a(pc.bias)
    for i, layer in enumerate(enc.layers):
        pre = f"encoder.layers.{i}"
        put(f"{pre}.layer_norm", a(layer.attn_ln.weight), a(layer.attn_ln.bias))
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put(f"{pre}.attention.{name}", *dense(getattr(layer, name)))
        put(f"{pre}.final_layer_norm", a(layer.ffn_ln.weight), a(layer.ffn_ln.bias))
        put(f"{pre}.feed_forward.intermediate_dense", *dense(layer.ffn_in))
        put(f"{pre}.feed_forward.output_dense", *dense(layer.ffn_out))
    h = enc.cfg.hidden_size
    put("encoder.layer_norm", np.ones(h, np.float32), np.zeros(h, np.float32))
    return {f"wav2vec2.{k}": v for k, v in sd.items()}


def write_safetensors(path: str, tensors: dict) -> None:
    """The `.safetensors` format by hand, every tensor F32: an 8-byte
    little-endian header length, the JSON header (padded to 8 bytes), the
    raw little-endian data."""
    import numpy as np

    header, offset = {}, 0
    arrays = {k: np.ascontiguousarray(v, dtype="<f4") for k, v in tensors.items()}
    for name, arr in arrays.items():
        header[name] = {"dtype": "F32", "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for arr in arrays.values():
            arr.tofile(f)


def run_hf_import(torch, cfg, clips: int, fmt: str, name: str) -> dict:
    """Export a seeded pipeline's encoder as a HF checkpoint
    (`hf_state_dict`), write it as `model.safetensors` (`write_safetensors`)
    or `pytorch_model.bin` into a temporary directory, import it into a
    pipeline of another seed through `params_from_hf_dir` and
    `convert.load_encoder`, and require the explain of `clips` seeded clips
    to equal the source's bit for bit. The source first takes the
    weight-norm positional conv it exports (`_wn_effective_weight`).
    Returns the imported pipeline's explain launches."""
    import os
    import tempfile

    import numpy as np

    from xai_audio_deepfakes_tpu_torch.convert import load_encoder
    from xai_audio_deepfakes_tpu_torch.models.wav2vec2 import (
        _wn_effective_weight,
        params_from_hf_dir,
    )
    from xai_audio_deepfakes_tpu_torch.ops import _cuda

    src = build_pipeline(torch, cfg, seed=0)
    sd = hf_state_dict(torch, src.encoder, seed=6)
    w_eff = _wn_effective_weight({k.removeprefix("wav2vec2."): v for k, v in sd.items()},
                                 "encoder.pos_conv_embed.conv")
    with torch.no_grad():
        src.encoder.pos_conv.conv.weight.copy_(torch.from_numpy(w_eff))
    nbytes = sum(v.nbytes for v in sd.values())
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        if fmt == "safetensors":
            write_safetensors(os.path.join(tmp, "model.safetensors"), sd)
        else:
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                       os.path.join(tmp, "pytorch_model.bin"))
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        params = params_from_hf_dir(tmp, cfg.embedder)
        t_read = time.perf_counter() - t0
    del sd
    dst = build_pipeline(torch, cfg, seed=1)
    load_encoder(dst.encoder, params["params"])
    dst.unet.load_state_dict(src.unet.state_dict())
    dst.logreg = dict(src.logreg)
    wav = torch.from_numpy((np.random.default_rng(7).standard_normal(
        (clips, cfg.audio.num_samples)) * 0.1).astype(np.float32)).cuda()
    want = src.explain(wav)
    _cuda.reset_launches()
    got = dst.explain(wav)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    print(f"HF import {name} ({fmt}, {nbytes / 1e9:.3f} GB f32): written in {t_write:.2f} s, "
          f"read and mapped in {t_read:.2f} s; explain launches {launches}")
    for key in ("probs_clean", "probs_relevant", "probs_irrelevant", "relevant_wav", "mask"):
        same = torch.equal(getattr(got, key), getattr(want, key))
        print(f"  {key}: bit for bit {'equal' if same else 'DIFFERENT'}")
        if not same:
            fail(f"HF import {name}: {key} differs from the source weights' explain")
    return launches


def run_training_remat(torch, cfg) -> dict:
    """Two identical no-remat steps through `make_train_step` (which takes
    cuDNN's deterministic algorithms): losses and decoder gradients bit for
    bit equal. Then three training steps at 2 clips with remat off, "full"
    and "dots" (same seed, same clips): step ms, peak memory, launches (the
    checkpointed layers rerun kernel A in the backward pass: A 27 + 18 a
    step) and the first step's decoder gradients against remat off (1e-3 of
    their scale). Returns {path: launches of the three steps}."""
    import numpy as np

    b = cfg.train.batch_size
    rng = np.random.default_rng(4)
    wavs = [(rng.standard_normal((b, cfg.audio.num_samples)) * 0.1).astype(np.float32)
            for _ in range(3)]
    paths, first_grads = {}, {}
    twice = [_remat_steps(torch, cfg, wavs[:1], "off")[1:] for _ in range(2)]
    same_loss = twice[0][1] == twice[1][1]
    same_grads = bool(torch.equal(twice[0][0], twice[1][0]))
    spread = float((twice[0][0] - twice[1][0]).abs().max()) / float(twice[1][0].abs().max())
    print(f"training remat off twice through make_train_step: losses "
          f"{'equal' if same_loss else 'DIFFERENT'} ({twice[0][1]!r}, {twice[1][1]!r}), decoder "
          f"gradients bit for bit {'equal' if same_grads else 'DIFFERENT'} (spread {spread:.3e} "
          f"of their largest magnitude)")
    if not (same_loss and same_grads):
        fail("two identical training steps gave different losses or decoder gradients")
    del twice
    for policy in ("off", "full", "dots"):
        paths[f"train_remat_{policy}_3_steps"], first_grads[policy], _ = _remat_steps(
            torch, cfg, wavs, policy)
    ref = first_grads["off"].cpu()
    for policy in ("full", "dots"):
        check_close(f"first step's decoder gradients, remat {policy} vs off",
                    first_grads[policy].cpu(), ref, 1e-3 * float(ref.abs().max()))
    return paths


def _remat_steps(torch, cfg, wavs, policy: str):
    """Training steps on `wavs` from a fresh seeded pipeline with remat
    `policy` -> (launches, the first step's decoder gradients, its loss)."""
    from xai_audio_deepfakes_tpu_torch.ops import _cuda
    from xai_audio_deepfakes_tpu_torch.train.train_addvisor import init_train_state, make_train_step

    e, b, n = cfg.embedder, cfg.train.batch_size, len(wavs)
    emb = dataclasses.replace(e, remat=policy != "off",
                              remat_policy="full" if policy == "off" else policy)
    pipe = build_pipeline(torch, cfg.replace(embedder=emb))
    fusable = sum(blk.fusable for blk in pipe.encoder.feature_encoder.conv_layers)
    state, step = init_train_state(pipe), make_train_step(pipe)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    times = []
    for i, wav in enumerate(wavs):
        t0 = time.perf_counter()
        _, aux = step(state, wav)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            first_grad = torch.cat([p.grad.flatten() for p in pipe.unet.parameters()])
            first_loss = float(aux["loss"])
        if not bool(torch.isfinite(aux["loss_vec"]).all()):
            fail(f"training remat {policy}: non-finite losses")
    launches = dict(_cuda.LAUNCHES)
    recompute = 2 * e.num_layers if policy != "off" else 0
    want = launches_of(a=n * (3 * e.num_layers + recompute), b=n, c=2 * n,
                       d=3 * n * (len(e.conv_dim) - fusable), e=3 * n * fusable)
    steady = f" (steady {sum(times[1:]) / (n - 1):.1f})" if n > 1 else ""
    print(f"training remat {policy}, {n} steps at {b} clips: step ms "
          f"{[round(t, 1) for t in times]}{steady}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launches}, "
          f"first loss {first_loss!r}")
    if launches != want:
        fail(f"training remat {policy}: launch counts {launches} != {want}")
    del pipe, state, step
    torch.cuda.empty_cache()
    return launches, first_grad, first_loss


def run_features_training(torch, cfg) -> dict:
    """One full-width training step of the feature decoder at 2 clips after
    a warm-up step: launches (one clean embed serves target and decoder
    input: A 27, as in the UNet's step), finite losses, decoder changed,
    embedder bit-identical; step ms and peak memory."""
    import numpy as np

    from xai_audio_deepfakes_tpu_torch.ops import _cuda
    from xai_audio_deepfakes_tpu_torch.train.train_addvisor import init_train_state, make_train_step

    e, b = cfg.embedder, cfg.train.batch_size
    pipe = build_pipeline(torch, cfg)
    state = init_train_state(pipe, decoder="features")
    step = make_train_step(pipe, decoder="features")
    rng = np.random.default_rng(9)
    wavs = [(rng.standard_normal((b, cfg.audio.num_samples)) * 0.1).astype(np.float32)
            for _ in range(2)]
    enc_before = [p.detach().clone() for p in pipe.encoder.parameters()]
    dec_before = [p.detach().clone() for p in pipe.feat_decoder.parameters()]
    step(state, wavs[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    _, aux = step(state, wavs[1])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_cuda.LAUNCHES)
    fusable = sum(blk.fusable for blk in pipe.encoder.feature_encoder.conv_layers)
    want = launches_of(a=3 * e.num_layers, b=1, c=2, d=3 * (len(e.conv_dim) - fusable),
                       e=3 * fusable)
    vec = aux["loss_vec"].cpu()
    print(f"training step, decoder=features, {b} clips: {ms:.1f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launches}, "
          f"losses {[round(v, 5) for v in vec.tolist()]}")
    if launches != want:
        fail(f"feature-decoder training step: launch counts {launches} != {want}")
    if not bool(torch.isfinite(vec).all()):
        fail("feature-decoder training step: non-finite losses")
    if not all(torch.equal(a, p) for a, p in zip(enc_before, pipe.encoder.parameters())):
        fail("feature-decoder training changed an embedder parameter")
    if all(torch.equal(a, p) for a, p in zip(dec_before, pipe.feat_decoder.parameters())):
        fail("feature-decoder training changed no decoder parameter")
    return launches


def tiny_aligned_config():
    """80000-sample clips through the default conv kernels and strides (249
    frames, as the STFT's) at narrow widths, a feature decoder with one
    attention block."""
    from xai_audio_deepfakes_tpu_torch.config import (
        EmbedderConfig,
        FeatDecoderConfig,
        PipelineConfig,
        UNetConfig,
    )

    return PipelineConfig(
        embedder=EmbedderConfig(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                                conv_dim=(8,) * 7, num_conv_pos_embeddings=16,
                                num_conv_pos_embedding_groups=2, output_layer=2),
        unet=UNetConfig(freq_bins=64, frames=24, base_channels=4),
        feat_decoder=FeatDecoderConfig(feature_dim=32, hidden=16, attn_layers=1))


def twin_pipelines(torch, cfg, seed: int = 5):
    """The same random weights on the card and on the CPU."""
    from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline

    gpu = ADDvisorPipeline(cfg, device="cuda", seed=seed)
    cpu = ADDvisorPipeline(cfg, device="cpu", seed=seed)
    for name in ("encoder", "unet", "feat_decoder"):
        getattr(cpu, name).load_state_dict(getattr(gpu, name).state_dict())
    cpu.logreg = {k: v.cpu() for k, v in gpu.logreg.items()}
    return gpu, cpu


def run_tiny_features_and_attribution(torch) -> None:
    """A tiny f32 feature-decoder explain (aligned geometry, one attention
    block) and a tiny f32 `input_x_gradient` on the card against the CPU:
    mask 1e-5, waveforms 2e-4, probabilities 1e-4; the map within 1e-3 of
    its largest magnitude."""
    from xai_audio_deepfakes_tpu_torch.attrib.methods import input_x_gradient
    from xai_audio_deepfakes_tpu_torch.config import (
        AudioConfig,
        EmbedderConfig,
        PipelineConfig,
        UNetConfig,
    )
    from xai_audio_deepfakes_tpu_torch.models.logreg import logreg_apply

    gpu, cpu = twin_pipelines(torch, tiny_aligned_config())
    wav = torch.randn(2, 80000, generator=torch.Generator().manual_seed(10)) * 0.1
    out_g = gpu.explain(wav.cuda(), decoder="features")
    out_c = cpu.explain(wav, decoder="features")
    torch.cuda.synchronize()
    for name, atol in (("mask", 1e-5), ("relevant_wav", 2e-4), ("irrelevant_wav", 2e-4),
                       ("probs_clean", 1e-4), ("probs_relevant", 1e-4), ("probs_irrelevant", 1e-4)):
        check_close(f"tiny features explain {name}", getattr(out_g, name).cpu(),
                    getattr(out_c, name), atol)

    cfg = PipelineConfig(audio=AudioConfig(clip_seconds=0.5), embedder=EmbedderConfig.tiny(),
                         unet=UNetConfig(freq_bins=64, frames=24, base_channels=4))
    gpu, cpu = twin_pipelines(torch, cfg)
    wav = torch.randn(2, 8000, generator=torch.Generator().manual_seed(11)) * 0.1
    maps = []
    for pipe, w in ((gpu, wav.cuda()), (cpu, wav)):
        def score(x, pipe=pipe):
            return logreg_apply(pipe.logreg, pipe.embed(x).mean(dim=1))[0]

        maps.append(input_x_gradient(score, w).cpu())
    check_close("tiny input_x_gradient map", maps[0], maps[1], 1e-3 * float(maps[1].abs().max()))


PAIRS = 8  # real clips and twins of the datagen phase


def write_pair_corpus(root: Path, cfg) -> list[str]:
    """PAIRS seeded speech-like clips as 16-bit wavs at 16 kHz under
    root/real and wideband-noise twins at 22.05 kHz under root/vocoded (the
    CLI's `<name>_vocoded.wav`), and a metadata file of the names; returns
    the names as `extract_wavs` reads them back."""
    import numpy as np

    from xai_audio_deepfakes_tpu_torch.data.datasets import extract_wavs
    from xai_audio_deepfakes_tpu_torch.data.io import write_wav
    from xai_audio_deepfakes_tpu_torch.data.synthetic import noise_clips, speechlike_clips

    rng = np.random.default_rng(20)
    real = speechlike_clips(rng, PAIRS, cfg.audio.num_samples)
    twins = noise_clips(rng, PAIRS, int(cfg.audio.clip_seconds * 22050), rms=0.25)
    names = [f"clip_{i}.wav" for i in range(PAIRS)]
    for name, r, t in zip(names, real, twins):
        write_wav(str(root / "real" / name), r, 16000)
        write_wav(str(root / "vocoded" / f"{name}_vocoded.wav"), t, 22050)
    (root / "metadata.csv").write_text("".join(f"{name},bonafide\n" for name in names))
    return extract_wavs(str(root / "metadata.csv"))


def run_datagen_and_embed(torch, root: Path) -> dict:
    """The `datagen` and `embed` commands' sequence of calls at full width in
    the CLI's default configuration (`EmbedderConfig(dtype="bfloat16")`, the
    unfused frontend): seeded wavs written and read back through
    `extract_wavs` and `load_audio` (the twins resampled from 22.05 kHz),
    `generate_band_swap_features` over the 8 pairs -> X [72, 1920] with
    8 zeros and 64 ones in y, launches per pair A 18, B 2, C 1, D 0, E 0,
    ms per pair with the device split (splice, embed at 1, embed at 8); then
    `AudioBatcher` at batch 4 over the 8 real files, pooled features and
    `classify_features` probabilities, finite and in (0, 1)."""
    import numpy as np

    from xai_audio_deepfakes_tpu_torch.config import EmbedderConfig, PipelineConfig
    from xai_audio_deepfakes_tpu_torch.data import native_io
    from xai_audio_deepfakes_tpu_torch.data.bandswap import (
        band_spliced_waveforms,
        generate_band_swap_features,
    )
    from xai_audio_deepfakes_tpu_torch.data.datasets import AudioBatcher
    from xai_audio_deepfakes_tpu_torch.data.io import load_audio
    from xai_audio_deepfakes_tpu_torch.ops import _cuda

    cfg = PipelineConfig(embedder=EmbedderConfig(dtype="bfloat16"))
    e, h = cfg.embedder, cfg.embedder.hidden_size
    t0 = time.perf_counter()
    names = write_pair_corpus(root, cfg)
    print(f"datagen: {PAIRS} clips and twins written in {time.perf_counter() - t0:.3f} s; wav "
          f"decoder: {'native ' + native_io.LIBRARY.name if native_io.available() else 'scipy'}")

    def pairs():  # cmd_datagen's reader
        for name in names:
            yield (load_audio(str(root / "real" / name))[0],
                   load_audio(str(root / "vocoded" / f"{name}_vocoded.wav"))[0])

    t0 = time.perf_counter()
    clips = list(pairs())
    read_s = time.perf_counter() - t0
    pipe = build_pipeline(torch, cfg)

    def embed_fn(w):
        return pipe.features(w).mean(dim=1)

    generate_band_swap_features(clips[:1], embed_fn)  # warm-up
    torch.cuda.synchronize()
    _cuda.reset_launches()
    logs: list = []
    t0 = time.perf_counter()
    x, y = generate_band_swap_features(pairs(), embed_fn, log_fn=logs.append)
    wall = time.perf_counter() - t0  # the features come to the host: the device is done
    launches = dict(_cuda.LAUNCHES)
    per_pair = launches_of(a=2 * e.num_layers, b=2, c=1)
    print(f"datagen launches for {PAIRS} pairs: {launches}; leakage warnings {logs}")
    if launches != {k: PAIRS * v for k, v in per_pair.items()}:
        fail(f"datagen: launch counts {launches} != {PAIRS} x {per_pair}")
    if x.shape != (9 * PAIRS, h) or x.dtype != np.float32 or not np.isfinite(x).all():
        fail(f"datagen: X {x.shape} {x.dtype}, finite {bool(np.isfinite(x).all())}")
    if (y == 0).sum() != PAIRS or (y == 1).sum() != 8 * PAIRS:
        fail(f"datagen: labels {np.bincount(y)}")
    real, twin = (torch.from_numpy(a).cuda() for a in clips[0])
    with torch.inference_mode():
        waves = band_spliced_waveforms(real, twin, cfg.stft)[0]
        split = {"splice": time_ms(lambda: band_spliced_waveforms(real, twin, cfg.stft), 5),
                 "embed_1": time_ms(lambda: embed_fn(real[None]), 5),
                 "embed_8": time_ms(lambda: embed_fn(waves), 5)}
    print(f"datagen at full width (CLI default: bf16, unfused frontend): X {list(x.shape)}, "
          f"y {np.bincount(y).tolist()}; {wall / PAIRS * 1e3:.1f} ms a pair with the wav reads "
          f"({read_s / PAIRS * 1e3:.1f} ms a pair alone), "
          f"{9 * PAIRS / wall:.1f} embedded clips/s; device ms a pair: "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))

    batcher = AudioBatcher(names, 4, root=str(root / "real"), shuffle=False,
                           drop_remainder=False)
    _cuda.reset_launches()
    pooled, probs = [], []
    t0 = time.perf_counter()
    for wav in batcher:  # cmd_embed's loop
        feats = pipe.features(wav)
        pooled.append(feats.mean(dim=1).cpu())
        probs.append(pipe.classify_features(feats)[1].cpu())
    embed_s = time.perf_counter() - t0
    embed_launches = dict(_cuda.LAUNCHES)
    pooled, probs = torch.cat(pooled), torch.cat(probs)
    print(f"embed, AudioBatcher at batch 4 over {PAIRS} files: {embed_s * 1e3:.1f} ms, "
          f"launches {embed_launches}, pooled {list(pooled.shape)}, probs "
          f"{[round(v, 4) for v in probs.flatten().tolist()]}")
    if embed_launches != launches_of(a=e.num_layers * len(batcher)):
        fail(f"embed: launch counts {embed_launches}")
    if tuple(pooled.shape) != (PAIRS, h) or not bool(torch.isfinite(pooled).all()):
        fail("embed: pooled features of the wrong shape or not finite")
    if not bool(((probs > 0) & (probs < 1)).all()):
        fail("embed: a probability outside (0, 1)")
    del pipe
    torch.cuda.empty_cache()
    return {"datagen_per_pair": {k: v // PAIRS for k, v in launches.items()},
            "embed_4": embed_launches}


def run_detector_corpus(torch, root: Path) -> dict:
    """The anyband detector corpus (`make_anyband_corpus(n=16)`,
    `detector_corpus_anyband` with the sweep and 4 random masks) on the card
    and on the CPU from the same seeds: clips within the STFT bar 2e-4,
    labels equal. Embedded at batch 8 in the kernel D configuration
    (`fused_ln_gelu=True`; the ragged tail zero-padded to 8), the detector
    fit and evaluated by `train_detector`, its head saved, loaded back and
    installed in the pipeline: `classify` on the first 8 held-out clips
    agrees with the fitted head on their corpus features within 1e-6 (the
    same kernels at the same batch shape; a clip's features do not depend
    on its batch neighbours). Then `per_clip_band_stats` over the UNet masks
    of two explains of the 16 manipulated clips, every statistic finite.
    Returns {path: launches}."""
    import numpy as np

    from xai_audio_deepfakes_tpu_torch.config import EmbedderConfig, PipelineConfig
    from xai_audio_deepfakes_tpu_torch.data.synthetic import (
        detector_corpus_anyband,
        make_anyband_corpus,
    )
    from xai_audio_deepfakes_tpu_torch.metrics.localization import per_clip_band_stats
    from xai_audio_deepfakes_tpu_torch.models.logreg import (
        logreg_apply,
        logreg_params_from_any,
        logreg_params_save,
    )
    from xai_audio_deepfakes_tpu_torch.ops import _cuda
    from xai_audio_deepfakes_tpu_torch.train.train_logreg import stratified_split, train_detector

    cfg = PipelineConfig(embedder=EmbedderConfig(dtype="bfloat16", fused_ln_gelu=True))
    e, n, sc = cfg.embedder, cfg.audio.num_samples, cfg.stft
    corpora = {}
    for device in ("cuda", "cpu"):
        if device == "cuda":
            _cuda.reset_launches()
        t0 = time.perf_counter()
        real, man, bands = make_anyband_corpus(np.random.default_rng(21), CORPUS, n, sc,
                                               device=device)
        wavs, labels = detector_corpus_anyband(real, man, sc, bands,
                                               rng=np.random.default_rng(22), n_random_masks=4,
                                               device=device)
        corpora[device] = (real, man, bands, wavs, labels, time.perf_counter() - t0)
        if device == "cuda":
            build_launches = dict(_cuda.LAUNCHES)
    real, man, bands, wavs, labels, build_s = corpora["cuda"]
    print(f"anyband corpus ({CORPUS} clips, sweep, 4 random masks): {wavs.shape[0]} clips, "
          f"labels {np.bincount(labels).tolist()}, built in {build_s:.2f} s on the card "
          f"({corpora['cpu'][5]:.2f} s on the CPU), launches {build_launches}")
    for i, name in ((0, "real"), (2, "bands"), (4, "labels")):
        if not np.array_equal(corpora["cuda"][i], corpora["cpu"][i]):
            fail(f"anyband corpus: {name} differ between the card and the CPU")
    check_close("anyband corpus manipulated clips, card vs CPU", torch.from_numpy(man),
                torch.from_numpy(corpora["cpu"][1]), 2e-4)
    check_close("anyband detector corpus, card vs CPU", torch.from_numpy(wavs),
                torch.from_numpy(corpora["cpu"][3]), 2e-4)
    del corpora

    pipe = build_pipeline(torch, cfg)
    pipe.features(wavs[:BATCH])  # warm-up
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    feats = []
    for i in range(0, len(wavs), BATCH):
        chunk = wavs[i:i + BATCH]
        padded = np.zeros((BATCH, n), np.float32)
        padded[:len(chunk)] = chunk
        feats.append(pipe.features(padded).mean(dim=1)[:len(chunk)].cpu())
    x = torch.cat(feats).numpy()
    embed_s = time.perf_counter() - t0
    batches = -(-len(wavs) // BATCH)
    corpus_launches = {k: build_launches[k] + v for k, v in _cuda.LAUNCHES.items()}
    print(f"anyband corpus embed at batch {BATCH} (kernel D config): {len(wavs)} clips in "
          f"{batches} batches, {embed_s:.3f} s, {len(wavs) / embed_s:.1f} clips/s, launches "
          f"{dict(_cuda.LAUNCHES)}")
    if dict(_cuda.LAUNCHES) != launches_of(a=e.num_layers * batches, d=len(e.conv_dim) * batches):
        fail(f"corpus embed: launch counts {dict(_cuda.LAUNCHES)}")
    if not np.isfinite(x).all():
        fail("corpus embed: non-finite features")

    logs: list = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, metrics = train_detector(x, labels, log_fn=logs.append)
    fit_s = time.perf_counter() - t0
    print(f"train_detector on {x.shape}: accuracy {metrics['accuracy']!r}, EER "
          f"{metrics['eer']!r}, L-BFGS {logs[0]['lbfgs']}, {fit_s:.3f} s")
    if not (0.0 <= metrics["eer"] <= 1.0 and 0.0 <= metrics["accuracy"] <= 1.0):
        fail(f"train_detector: metrics out of range {metrics}")
    head_path = root / "logreg_vocoded_anyband.npz"
    logreg_params_save(params, str(head_path))
    pipe.logreg = logreg_params_from_any(str(head_path))
    _, test_idx, _, _ = stratified_split(np.arange(len(labels)), labels)
    held = test_idx[:BATCH]
    _, p_pipe = pipe.classify(wavs[held])
    _, p_fit = logreg_apply(params, torch.from_numpy(x[held]).cuda())
    check_close("reloaded head in the pipeline: classify vs the fitted head on the corpus "
                "features, 8 held-out clips", p_pipe, p_fit, 1e-6)

    _cuda.reset_launches()
    masks = torch.cat([pipe.explain(man[i:i + BATCH]).mask.cpu() for i in (0, BATCH)])
    local_launches = dict(_cuda.LAUNCHES)
    stats = per_clip_band_stats(masks.numpy(), sc, bands, freq_bins=cfg.unet.freq_bins,
                                frames=cfg.unet.frames)
    scalars = {k: v for k, v in stats.items() if k != "per_clip"}
    print(f"per_clip_band_stats over the masks of 2 explains of the {CORPUS} manipulated "
          f"clips: {json.dumps(scalars)}; launches {local_launches}")
    values = list(scalars.values()) + [v for c in stats["per_clip"] for v in c.values()]
    if any(v is None or not math.isfinite(v) for v in values):
        fail("per_clip_band_stats: a statistic is missing or not finite")
    del pipe
    torch.cuda.empty_cache()
    return {"detector_corpus": corpus_launches, "detector_localization": local_launches}


def run_solver_full_width(torch) -> None:
    """`fit_logreg` on the card on seeded features [4096, 1920] with a noisy
    linear label (signal scale 0.5 under logistic noise: not separable at
    this n / d, so the optimum is finite) against scipy's L-BFGS-B in
    float64 on the same objective: cosine of the weights above 0.999, the
    objective (float64, at the card's weights) within 1e-4 relative of
    scipy's optimum."""
    import numpy as np
    import scipy.optimize

    from xai_audio_deepfakes_tpu_torch.train.train_logreg import fit_logreg

    n, d, c = 4096, 1920, 1e6
    rng = np.random.default_rng(23)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w0 = rng.standard_normal(d) / math.sqrt(d)
    y = ((x @ w0) * 0.5 + rng.logistic(size=n) > 0).astype(np.int64)
    logs: list = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = fit_logreg(x, y, c=c, log_fn=logs.append)
    fit_s = time.perf_counter() - t0
    xd, yd = x.astype(np.float64), y.astype(np.float64)

    def objective(v):
        z = xd @ v[:d] + v[d]
        val = np.sum(np.maximum(z, 0) - z * yd + np.log1p(np.exp(-np.abs(z))))
        val += 0.5 / c * v[:d] @ v[:d]
        r = 0.5 * (1 + np.tanh(0.5 * z)) - yd  # sigmoid(z) - y without overflow
        return val, np.concatenate([xd.T @ r + v[:d] / c, [r.sum()]])

    t0 = time.perf_counter()
    ref = scipy.optimize.minimize(objective, np.zeros(d + 1), jac=True, method="L-BFGS-B",
                                  options={"maxiter": 15000})
    scipy_s = time.perf_counter() - t0
    mine = np.concatenate([params["weight"].cpu().numpy()[:, 0],
                           params["bias"].cpu().numpy()]).astype(np.float64)
    cos = float(mine[:d] @ ref.x[:d] / (np.linalg.norm(mine[:d]) * np.linalg.norm(ref.x[:d])))
    rel = (objective(mine)[0] - ref.fun) / ref.fun
    acc = float(np.mean((xd @ ref.x[:d] + ref.x[d] > 0) == y))
    print(f"fit_logreg [{n}, {d}] on the card: {fit_s:.3f} s, {logs[0]['lbfgs']}; scipy L-BFGS-B "
          f"float64: {ref.nit} iterations, {scipy_s:.2f} s, objective {float(ref.fun)!r} (training "
          f"accuracy {acc:.4f}: not separable); cosine {cos!r} (bar > 0.999), objective "
          f"{rel:.3e} relative (bar 1e-4)")
    if not (cos > 0.999 and abs(rel) <= 1e-4):
        fail("fit_logreg at full width disagrees with scipy")


def run_tiny_detector(torch) -> None:
    """Tiny card against CPU on the same weights: `band_spliced_waveforms`
    (the STFT bar, 2e-4) and `generate_band_swap_features`' pooled features
    through the tiny f32 encoder (its bar, 5e-4)."""
    import numpy as np

    from xai_audio_deepfakes_tpu_torch.config import (
        AudioConfig,
        EmbedderConfig,
        PipelineConfig,
        UNetConfig,
    )
    from xai_audio_deepfakes_tpu_torch.data.bandswap import (
        band_spliced_waveforms,
        generate_band_swap_features,
    )

    cfg = PipelineConfig(audio=AudioConfig(clip_seconds=0.5), embedder=EmbedderConfig.tiny(),
                         unet=UNetConfig(freq_bins=64, frames=24, base_channels=4))
    gpu, cpu = twin_pipelines(torch, cfg)
    rng = np.random.default_rng(24)
    pairs = [(rng.standard_normal(8000).astype(np.float32) * 0.1,
              rng.standard_normal(8000).astype(np.float32) * 0.3) for _ in range(2)]
    real, twin = (torch.from_numpy(a) for a in pairs[0])
    with torch.inference_mode():
        got = band_spliced_waveforms(real.cuda(), twin.cuda(), cfg.stft)[0].cpu()
        want = band_spliced_waveforms(real, twin, cfg.stft)[0]
    check_close("tiny band_spliced_waveforms, card vs CPU", got, want, 2e-4)
    feats = [generate_band_swap_features(pairs, lambda w, p=p: p.features(w).mean(dim=1),
                                         device=p.device)[0] for p in (gpu, cpu)]
    check_close("tiny generate_band_swap_features, card vs CPU", torch.from_numpy(feats[0]),
                torch.from_numpy(feats[1]), 5e-4)


def _flat_state(sd, prefix: str = "") -> dict:
    out = {}
    for k, v in sd.items():
        if isinstance(v, dict):
            out.update(_flat_state(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def run_closed_loop_reduced(torch, root: Path) -> dict:
    """`run_closed_loop(anyband=True)` at full width in the anyband
    protocol's configuration (`closed_loop.anyband_protocol_config`):
    32 training and 16 evaluation clips, 3 epochs at batch 16 (2 steps an
    epoch), noise rms 1.0, every epoch checkpointed asynchronously and an
    `artifact_fn` recording each epoch's first mask. Prints the detector's
    accuracy and EER, the epoch records with their `sec`, localisation,
    keep and flip rates and faithfulness before and after training, and the
    launches and seconds of each stage (the stages' functions wrapped in the
    module; the embeds of the detector corpus and of the held-out check are
    the rest). Checks: the launches of every stage; `artifact_fn` called
    once per epoch with a finite [512, 248] mask; each epoch's checkpoint
    holds that epoch's step count and loss weights (the record's `w`), and
    the last reloads bit for bit into a fresh state; finite statistics.
    Returns {stage: launches}."""
    import numpy as np

    from xai_audio_deepfakes_tpu_torch.losses.lmac import init_w_raw, softplus_weights
    from xai_audio_deepfakes_tpu_torch.models.unet import UNetMaskDecoder
    from xai_audio_deepfakes_tpu_torch.ops import _cuda
    from xai_audio_deepfakes_tpu_torch.train import artifacts, checkpoints, closed_loop
    from xai_audio_deepfakes_tpu_torch.train.train_addvisor import (
        AddvisorTrainState,
        make_optimizers,
    )

    cfg = closed_loop.anyband_protocol_config()
    e, epochs, n_eval = cfg.embedder, 3, LOOP_BATCH
    steps = epochs * (LOOP_TRAIN // LOOP_BATCH)
    stages: dict = {}

    def counted(name, fn):
        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            before, t0 = dict(_cuda.LAUNCHES), time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            rec = stages.setdefault(name, {"calls": 0, "s": 0.0, "launches": launches_of()})
            rec["calls"] += 1
            rec["s"] += time.perf_counter() - t0
            for k in rec["launches"]:
                rec["launches"][k] += _cuda.LAUNCHES[k] - before[k]
            return out
        return wrapped

    arts, saved, records = [], [], []

    def artifact_fn(epoch, mask, aux):
        arts.append((epoch, tuple(mask.shape), bool(torch.isfinite(mask).all()),
                     float(mask.mean())))

    ckdir = root / "closed_loop_ckpts"
    shutil.rmtree(ckdir, ignore_errors=True)
    names = ("make_anyband_corpus", "detector_corpus_anyband", "train_detector",
             "evaluate_explanations", "train_addvisor")
    originals = {name: getattr(closed_loop, name) for name in names}
    for name in names:
        setattr(closed_loop, name, counted(name, originals[name]))
    _cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        res = closed_loop.run_closed_loop(
            cfg, seed=0, n_train=LOOP_TRAIN, n_eval=n_eval, epochs=epochs,
            batch_size=LOOP_BATCH, noise_rms=1.0, anyband=True, log_fn=records.append,
            artifact_fn=artifact_fn,
            checkpoint_fn=lambda ep, snap, loss: saved.append(checkpoints.save_checkpoint(
                str(ckdir), ep, loss, snap, async_save=True)))
    finally:
        for name in names:
            setattr(closed_loop, name, originals[name])
    wall = time.perf_counter() - t0
    checkpoints.wait_for_saves()
    total = dict(_cuda.LAUNCHES)
    stage_sum = {k: sum(r["launches"][k] for r in stages.values()) for k in total}
    embeds = {k: total[k] - stage_sum[k] for k in total}
    for name in names:
        print(f"  closed loop stage {name}: {stages[name]['calls']} calls, "
              f"{stages[name]['s']:.3f} s, launches {stages[name]['launches']}")
    print(f"  closed loop stage embeds (detector corpus, held-out check): launches {embeds}")

    a, n = e.num_layers, 2 * n_eval
    want = {
        "make_anyband_corpus": launches_of(b=4, c=2),
        "detector_corpus_anyband": launches_of(b=28, c=20),
        "train_detector": launches_of(),
        "evaluate_explanations": launches_of(a=3 * a, b=3, c=6),
        "train_addvisor": launches_of(a=steps * (3 * a + 2 * a), b=steps, c=2 * steps),
    }
    for name, w in want.items():
        if stages[name]["launches"] != w:
            fail(f"closed loop stage {name}: launches {stages[name]['launches']} != {w}")
    if embeds["attention"] % a or any(v for k, v in embeds.items() if k != "attention"):
        fail(f"closed loop embeds: launches {embeds}")
    det_batches = embeds["attention"] // a - n // LOOP_BATCH

    det, hold = res["detector"], res["detector_holdout"]
    print(f"closed loop (reduced: {LOOP_TRAIN} train / {n_eval} eval clips, {epochs} epochs at "
          f"batch {LOOP_BATCH}, {steps} steps; bf16, scan_layers, remat dots, lr 3e-4, noise "
          f"rms 1.0): wall {wall:.2f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; detector corpus embedded in "
          f"{det_batches} batches of {LOOP_BATCH}; detector accuracy {det['accuracy']!r}, EER "
          f"{det['eer']!r}; held out accuracy {hold['accuracy']!r}, EER {hold['eer']!r}")
    log = [r for r in records if "epoch" in r]
    for r in log:
        print(f"  epoch {r['epoch']}: loss {r['loss']:.5f} l_in {r['l_in']:.5f} "
              f"l_out {r['l_out']:.5f} l1 {r['l1']:.5f} w {[round(v, 5) for v in r['w']]} "
              f"sec {r['sec']:.3f}")
    for phase in ("before", "after", "after_train"):
        ph = res[phase]
        loc = {k: round(v, 4) for k, v in ph["localization"].items() if k != "per_clip"}
        print(f"  {phase}: {json.dumps(loc)}, keep {ph['keep_rate']}, flip {ph['flip_rate']}, "
              f"faithfulness {ph['metrics']['faithfulness']:.4f}, p_manipulated clean / relevant "
              f"/ irrelevant {ph['p_manipulated_clean']:.4f} / {ph['p_manipulated_relevant']:.4f}"
              f" / {ph['p_manipulated_irrelevant']:.4f}")
        values = list(ph["metrics"].values()) + list(loc.values())
        if not all(math.isfinite(v) for v in values):
            fail(f"closed loop {phase}: a statistic is not finite")
    if [r["epoch"] for r in log] != list(range(1, epochs + 1)):
        fail(f"closed loop: epoch records {[r['epoch'] for r in log]}")
    if not all(math.isfinite(r["loss"]) for r in log):
        fail("closed loop: a non-finite epoch loss")

    print(f"  artifact_fn calls (epoch, mask shape, finite, mean): {arts}")
    if [x[0] for x in arts] != list(range(epochs)) or not all(
            x[1] == (cfg.unet.freq_bins, cfg.unet.frames) and x[2] for x in arts):
        fail("closed loop: artifact_fn was not called once per epoch with a finite first mask")
    try:
        artifacts.save_mask_png(res["final_masks"][0], str(root / "closed_loop_mask_0.png"))
        print("  artifacts: matplotlib present, a mask PNG written")
    except ImportError as err:
        print(f"  artifacts: matplotlib absent on this machine, the PNG writers raise "
              f"ImportError ({err})")

    if [checkpoints.parse_checkpoint_name(p)[0] for p in saved] != list(range(1, epochs + 1)):
        fail(f"closed loop: checkpoints {saved}")
    for path, rec in zip(saved, log):
        sd = checkpoints.load_checkpoint(path, "cuda")
        got = softplus_weights(sd["w_raw"]).tolist()  # on the card, as the record's
        if sd["step"] != rec["epoch"] * (LOOP_TRAIN // LOOP_BATCH) or got != rec["w"]:
            fail(f"closed loop: checkpoint {path} holds step {sd['step']}, w {got}, not its "
                 f"epoch's ({rec['w']})")
    unet = UNetMaskDecoder(cfg.unet).cuda()
    w_raw = init_w_raw(cfg.loss, torch.device("cuda"))
    fresh = AddvisorTrainState(unet, w_raw, *make_optimizers(cfg, unet.parameters(), w_raw))
    checkpoints.restore_checkpoint(saved[-1], fresh)
    a_sd, b_sd = _flat_state(fresh.state_dict()), _flat_state(res["state"].state_dict())
    same = a_sd.keys() == b_sd.keys() and all(
        torch.equal(a_sd[k].cpu(), b_sd[k].cpu()) if isinstance(a_sd[k], torch.Tensor)
        else a_sd[k] == b_sd[k] for k in a_sd)
    print(f"  async checkpoints: {len(saved)} written ({[Path(p).name for p in saved]}); each "
          f"holds its epoch's step and loss weights; the last reloaded into a fresh state "
          f"{'bit for bit' if same else 'DIFFERENT'}")
    if not same:
        fail("closed loop: the last checkpoint does not reload bit for bit")
    shutil.rmtree(ckdir, ignore_errors=True)
    del res
    torch.cuda.empty_cache()
    out = {f"closed_loop_{name}": rec["launches"] for name, rec in stages.items()}
    out["closed_loop_embeds"] = embeds
    return out


def run_trainer_switches(torch, fused, f32_step_ms: float) -> dict:
    """One counted and timed training step at 2 clips (after a warm-up
    step) with each switch this slice ported, in the kernel D + E
    configuration: the bf16 UNet and `target_quant="int8"`. Launches A 27,
    B 1, C 2, D 3, E 18 (the int8 target embed runs the same kernels, its
    projections int8 products), finite losses, loss weights summing to 3,
    the decoder changed and its parameters f32; step ms and peak memory
    beside the f32 step's (`run_training`, same call). Returns {path:
    launches}."""
    import numpy as np

    from xai_audio_deepfakes_tpu_torch.config import TrainConfig, UNetConfig
    from xai_audio_deepfakes_tpu_torch.ops import _cuda
    from xai_audio_deepfakes_tpu_torch.train.train_addvisor import init_train_state, make_train_step

    e = fused.embedder
    paths = {}
    cases = {"bf16_unet": fused.replace(unet=UNetConfig(dtype="bfloat16")),
             "target_quant_int8": fused.replace(train=TrainConfig(target_quant="int8"))}
    rng = np.random.default_rng(9)
    wavs = [(rng.standard_normal((2, fused.audio.num_samples)) * 0.1).astype(np.float32)
            for _ in range(3)]
    for name, cfg in cases.items():
        pipe = build_pipeline(torch, cfg)
        fusable = sum(blk.fusable for blk in pipe.encoder.feature_encoder.conv_layers)
        state, step = init_train_state(pipe), make_train_step(pipe)
        before = [p.detach().clone() for p in pipe.unet.parameters()]
        step(state, wavs[0])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for wav in wavs[1:]:
            _cuda.reset_launches()
            t0 = time.perf_counter()
            _, aux = step(state, wav)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(_cuda.LAUNCHES)
        want = launches_of(a=3 * e.num_layers, b=1, c=2, d=3 * (len(e.conv_dim) - fusable),
                           e=3 * fusable)
        vec = aux["loss_vec"].cpu()
        print(f"training step, {name}, 2 clips (bf16 embedder, fused_ln_gelu, fused_conv): "
              f"{[round(t, 1) for t in times]} ms (the f32 UNet's steady "
              f"{f32_step_ms:.1f} ms in this call), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launches}, losses "
              f"{[round(v, 5) for v in vec.tolist()]}")
        if launches != want:
            fail(f"training step {name}: launch counts {launches} != {want}")
        if not bool(torch.isfinite(vec).all()) or abs(float(aux["w"].sum()) - 3.0) > 1e-4:
            fail(f"training step {name}: losses {vec.tolist()}, w {aux['w'].tolist()}")
        params = list(pipe.unet.parameters())
        if not all(p.dtype == torch.float32 for p in params) or all(
                torch.equal(a, p) for a, p in zip(before, params)):
            fail(f"training step {name}: decoder parameters not f32 or unchanged")
        paths[f"train_{name}_step"] = launches
        del pipe, state, step
        torch.cuda.empty_cache()
    return paths


def run_tiny_trainer_switches(torch) -> None:
    """A tiny training step with each new switch on the card against the
    same step on the CPU (conv widths of 128 and both fused frontend
    switches, as `run_tiny_training`). The int8 target at the training
    bars (losses 1e-4, the first mask 1e-5, decoder gradients 1e-3 of their
    scale; the int32 products are exact on both devices). The bf16 UNet:
    the first mask and the decoder gradients at mean |card - CPU| at most
    the mean of the CPU's own bf16-vs-f32 deviation and max at most its
    max, the losses at most 4x its largest (training-mode BatchNorm reduces
    in each device's own order, so bf16 roundings flip where serving's
    fixed statistics flip none)."""
    from xai_audio_deepfakes_tpu_torch.config import (
        AudioConfig,
        EmbedderConfig,
        PipelineConfig,
        TrainConfig,
        UNetConfig,
    )
    from xai_audio_deepfakes_tpu_torch.train.train_addvisor import init_train_state, make_train_step

    emb = dataclasses.replace(EmbedderConfig.tiny(), conv_dim=(128, 128, 128), fused_conv=True,
                              fused_ln_gelu=True)
    base = PipelineConfig(audio=AudioConfig(clip_seconds=0.5), embedder=emb,
                          unet=UNetConfig(freq_bins=64, frames=24, base_channels=4))
    wav = torch.randn(2, 8000, generator=torch.Generator().manual_seed(12)) * 0.1

    def run(cfg, device, weights):
        """One step from `weights` (encoder, UNet, head) on `device`."""
        from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline

        pipe = ADDvisorPipeline(cfg, device=device, seed=5)
        pipe.encoder.load_state_dict(weights[0])
        pipe.unet.load_state_dict(weights[1])
        pipe.logreg = {k: v.to(pipe.device) for k, v in weights[2].items()}
        _, aux = make_train_step(pipe)(init_train_state(pipe), wav.to(pipe.device))
        grads = torch.cat([p.grad.flatten().cpu() for p in pipe.unet.parameters()])
        return aux["loss_vec"].cpu(), aux["mask_first"].cpu(), grads

    for name, cfg in (("target_quant int8", base.replace(train=TrainConfig(target_quant="int8"))),
                      ("bf16 UNet", base.replace(unet=dataclasses.replace(base.unet,
                                                                          dtype="bfloat16")))):
        from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline

        src = ADDvisorPipeline(cfg, device="cpu", seed=5)  # the weights, before any step
        weights = ({k: v.clone() for k, v in src.encoder.state_dict().items()},
                   {k: v.clone() for k, v in src.unet.state_dict().items()}, src.logreg)
        card = run(cfg, "cuda", weights)
        cpu = run(cfg, "cpu", weights)
        ref = run(base, "cpu", weights)  # the exact target / f32 UNet, on the CPU
        print(f"tiny training step, {name}, card vs CPU:")
        for i, what in ((0, "losses"), (1, "first mask"), (2, "decoder gradients")):
            got, want, own = card[i], cpu[i], ref[i]
            if "int8" in name:
                # the training bars of `run_tiny_training`
                atol = {"losses": 1e-4, "first mask": 1e-5}.get(what, 1e-3 * float(
                    want.abs().max()))
                check_close(f"  {what}", got, want, atol)
                print(f"    rel_l2 {rel_l2(got, want):.3e}, the int8 target's own distance "
                      f"from the exact one {rel_l2(want, own):.3e}")
                continue
            err, dev = (got - want).abs(), (want - own).abs()
            scale = 4.0 if what == "losses" else 1.0
            ok = (what == "losses" or float(err.mean()) <= float(dev.mean())) and float(
                err.max()) <= scale * float(dev.max())
            print(f"  {what}: mean_abs_err {float(err.mean()):.3e} (own {float(dev.mean()):.3e}), "
                  f"max_abs_err {float(err.max()):.3e} (bar {scale * float(dev.max()):.3e}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"tiny training step {name}: {what} disagrees beyond its bar")


def run_vocoder(torch, root: Path) -> dict:
    """The vocoder path at full width in the CLI's default configuration
    (`EmbedderConfig(dtype="bfloat16")`, the default `HiFiGANConfig`: f32,
    512 initial channels) on BATCH seeded clips: `vocode` (B 1; output
    [8, 80128], finite, in [-1, 1]; ms, its mel / HiFi-GAN split, peak
    memory), `explain_vocoded(decoder="unet")` (A 9, B 2, C 2; ms beside the
    explain's and the vocode's alone), then `generate_vocoded_dataset` over
    datagen's 8 seeded wavs under `root/real` (64 band-spliced wavs; a file
    B 3, C 1; leakage warnings counted; ms a file). Returns {path:
    launches}."""
    import numpy as np

    from xai_audio_deepfakes_tpu_torch.config import EmbedderConfig, PipelineConfig
    from xai_audio_deepfakes_tpu_torch.data.datasets import extract_wavs
    from xai_audio_deepfakes_tpu_torch.data.vocoded import (
        generate_vocoded_dataset,
        make_vocoder_fn,
    )
    from xai_audio_deepfakes_tpu_torch.ops import _cuda
    from xai_audio_deepfakes_tpu_torch.ops.mel import mel_spectrogram

    cfg = PipelineConfig(embedder=EmbedderConfig(dtype="bfloat16"))
    e, n = cfg.embedder, cfg.audio.num_samples
    pipe = build_pipeline(torch, cfg)
    wav = torch.from_numpy(
        (np.random.default_rng(30).standard_normal((BATCH, n)) * 0.1).astype(np.float32)).cuda()
    paths = {}
    with torch.inference_mode():
        pipe.vocode(wav)  # warm-up, and the generator's first use builds it
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        voc = pipe.vocode(wav)
        torch.cuda.synchronize()
        paths["vocode"] = dict(_cuda.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        want_len = cfg.mel.hop_length * (1 + n // cfg.mel.hop_length)
        ok = (tuple(voc.shape) == (BATCH, want_len) and bool(torch.isfinite(voc).all())
              and float(voc.abs().max()) <= 1.0)
        mel = mel_spectrogram(wav, cfg.mel)
        split = {"mel (B + filterbank + log)": time_ms(lambda: mel_spectrogram(wav, cfg.mel), 5),
                 "HiFi-GAN": time_ms(lambda: pipe.hifigan(mel), 5)}
        vocode_ms = time_ms(lambda: pipe.vocode(wav), 5)
        print(f"vocode B={BATCH} (HiFi-GAN f32, {cfg.hifigan.upsample_initial_channel} initial "
              f"channels): {vocode_ms:.2f} ms, split "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
              + f"; output {list(voc.shape)}, |max| {float(voc.abs().max()):.4f}; peak memory "
              f"{peak:.2f} GiB; launches {paths['vocode']}")
        if not ok or paths["vocode"] != launches_of(b=1):
            fail(f"vocode: output {tuple(voc.shape)} (want {(BATCH, want_len)}), finite and "
                 f"bounded {ok}, launches {paths['vocode']}")

        pipe.explain_vocoded(wav)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        out, voc_rel = pipe.explain_vocoded(wav)
        torch.cuda.synchronize()
        paths["explain_vocoded"] = dict(_cuda.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = launches_of(a=e.num_layers, b=2, c=2)
        rel = out.relevant_wav
        split = {"explain": time_ms(lambda: pipe.explain(wav), 3),
                 "vocode of the relevant clips": time_ms(lambda: pipe.vocode(rel), 3),
                 "explain_vocoded": time_ms(lambda: pipe.explain_vocoded(wav), 3)}
        print(f"explain_vocoded B={BATCH}, decoder unet (bf16 embedder, f32 UNet, f32 HiFi-GAN): "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
              + f"; peak memory {peak:.2f} GiB; launches {paths['explain_vocoded']}")
        if paths["explain_vocoded"] != want:
            fail(f"explain_vocoded: launch counts {paths['explain_vocoded']} != {want}")
        if tuple(voc_rel.shape) != (BATCH, want_len) or not bool(torch.isfinite(voc_rel).all()):
            fail("explain_vocoded: the vocoded relevant clips are of the wrong shape or not finite")
        check_close("explain_vocoded's vocoded clips vs vocode of its relevant clips", voc_rel,
                    pipe.vocode(rel), 1e-5)

    names = extract_wavs(str(root / "metadata.csv"))
    out_dir = root / "vocoded_bands"
    shutil.rmtree(out_dir, ignore_errors=True)
    logs: list = []
    generate_vocoded_dataset(names[:1], str(root / "real"), str(out_dir / "warm"),
                             make_vocoder_fn(pipe))
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    written = generate_vocoded_dataset(names, str(root / "real"), str(out_dir),
                                       make_vocoder_fn(pipe), log_fn=logs.append)
    wall = time.perf_counter() - t0  # every file written from host arrays: the device is done
    paths["vocoded_datagen"] = dict(_cuda.LAUNCHES)
    files = sorted(p.name for p in out_dir.glob("*.wav"))
    print(f"generate_vocoded_dataset over {len(names)} wavs: {written} band-spliced wavs "
          f"written, {len(files)} files, {wall / len(names) * 1e3:.1f} ms a file, leakage "
          f"warnings {len(logs)}, launches {paths['vocoded_datagen']}")
    if written != 8 * len(names) or len(files) != written:
        fail(f"generate_vocoded_dataset: {written} written, {len(files)} files")
    if paths["vocoded_datagen"] != launches_of(b=3 * len(names), c=len(names)):
        fail(f"generate_vocoded_dataset: launch counts {paths['vocoded_datagen']}")
    del pipe
    torch.cuda.empty_cache()
    return paths


def run_tiny_vocoded(torch) -> None:
    """A tiny `explain_vocoded` (tests/test_pipeline.py::tiny_config's
    HiFi-GAN) on the card against the CPU with the same weights: mask 1e-5,
    waveforms 2e-4, probabilities 1e-4, the vocoded clips 1e-4 (their mel
    comes from waveforms within 2e-4, through a log)."""
    from xai_audio_deepfakes_tpu_torch.config import (
        AudioConfig,
        EmbedderConfig,
        HiFiGANConfig,
        PipelineConfig,
        UNetConfig,
    )

    cfg = PipelineConfig(
        audio=AudioConfig(clip_seconds=0.5), embedder=EmbedderConfig.tiny(),
        unet=UNetConfig(freq_bins=64, frames=24, base_channels=4),
        hifigan=HiFiGANConfig(upsample_initial_channel=8, upsample_rates=(4, 2),
                              upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3,),
                              resblock_dilations=((1, 3),)))
    gpu, cpu = twin_pipelines(torch, cfg)
    cpu.hifigan.load_state_dict(gpu.hifigan.state_dict())
    wav = torch.randn(2, 8000, generator=torch.Generator().manual_seed(13)) * 0.1
    out_g, voc_g = gpu.explain_vocoded(wav.to(gpu.device))
    out_c, voc_c = cpu.explain_vocoded(wav)
    torch.cuda.synchronize()
    for name, atol in (("mask", 1e-5), ("relevant_wav", 2e-4), ("irrelevant_wav", 2e-4),
                       ("probs_clean", 1e-4), ("probs_relevant", 1e-4), ("probs_irrelevant", 1e-4)):
        check_close(f"tiny explain_vocoded {name}", getattr(out_g, name).cpu(),
                    getattr(out_c, name), atol)
    check_close("tiny explain_vocoded vocoded relevant clips", voc_g.cpu(), voc_c, 1e-4)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from xai_audio_deepfakes_tpu_torch.config import EmbedderConfig, PipelineConfig, UNetConfig
    from xai_audio_deepfakes_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print("torch", torch.__version__, "cuda", torch.version.cuda, "device", torch.cuda.get_device_name(0))

    _cuda.library()
    print(f"kernels built in {_cuda.build_log['seconds']:.1f} s")
    for line in _cuda.build_log.get("ptxas", "").splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line or line.startswith("=="):
            print("  " + line.strip())
    check_sass(_cuda.build())

    # the frontend through kernel D: fused_ln_gelu=True at 512 channels
    cfg = PipelineConfig(embedder=EmbedderConfig(dtype="bfloat16", fused_ln_gelu=True))
    fused = cfg.replace(embedder=dataclasses.replace(cfg.embedder, fused_conv=True))
    rows: list = []
    with torch.inference_mode():
        check_attention(torch, cfg, rows)
        check_stft(torch, cfg, rows)
        check_ln_gelu(torch, cfg, rows)
        check_conv_ln_gelu(torch, cfg, rows)
    check_backwards(torch, cfg)
    check_backwards_bf16(torch, cfg)
    torch.cuda.empty_cache()

    n_layers, n_conv = cfg.embedder.num_layers, len(cfg.embedder.conv_dim)
    per_explain = launches_of(a=n_layers, b=1, c=2, d=n_conv)
    per_explain_fused = launches_of(a=n_layers, b=1, c=2, d=1, e=n_conv - 1)
    # the feature decoder embeds the clean clips (B) and the masked ones (2B)
    # in two passes: twice the embedder's launches, one STFT, two iSTFTs
    per_features = launches_of(a=2 * n_layers, b=1, c=2, d=2 * n_conv)
    per_features_fused = launches_of(a=2 * n_layers, b=1, c=2, d=2, e=2 * (n_conv - 1))
    paths: dict = {}
    pipe = build_pipeline(torch, cfg)
    counts = [run_explain(torch, cfg, per_explain, reps=2, pipe=pipe)]
    paths["explain_features"] = run_explain(torch, cfg, per_features, reps=2, name="features",
                                            split=True, decoder="features", pipe=pipe)[0]
    paths["eval_unet_3x8"] = run_eval(torch, pipe, "unet", per_explain)
    paths["eval_features_3x8"] = run_eval(torch, pipe, "features", per_features)
    paths.update(run_attribution(torch, pipe))
    del pipe
    torch.cuda.empty_cache()
    pipe = build_pipeline(torch, fused)
    counts.append(run_explain(torch, fused, per_explain_fused, reps=2, pipe=pipe))
    paths["explain_features_fused_conv"] = run_explain(
        torch, fused, per_features_fused, reps=2, name="features fused_conv", decoder="features",
        pipe=pipe)[0]
    del pipe
    # same seed, same weights: the two frontends differ by bf16 rounding only
    check_close("explain fused_conv probabilities vs default", counts[1][1], counts[0][1], 0.05)
    torch.cuda.empty_cache()
    train_launches, f32_step_ms = run_training(torch, fused)
    torch.cuda.empty_cache()
    paths.update(run_training_remat(torch, fused))
    paths["train_features_step"] = run_features_training(torch, fused)
    torch.cuda.empty_cache()
    paths["hf_import_explain"] = run_hf_import(torch, cfg, BATCH, "safetensors", "full width")
    torch.cuda.empty_cache()
    run_hf_import(torch, tiny_aligned_config(), 2, "bin", "tiny width")
    run_tiny_training(torch)
    paths.update(run_trainer_switches(torch, fused, f32_step_ms))
    torch.cuda.empty_cache()
    run_tiny_trainer_switches(torch)
    run_tiny_features_and_attribution(torch)

    # the JAX package's serving configurations: the entry point's (bf16,
    # fused_ln_gelu False) and bench.py's default (bf16, int8, tanh, bf16
    # UNet), then the same calibrated (int8-static); no frontend kernel runs
    entry = PipelineConfig(embedder=EmbedderConfig(dtype="bfloat16"))
    bench = PipelineConfig(embedder=EmbedderConfig(dtype="bfloat16", quant="int8", gelu="tanh"),
                           unet=UNetConfig(dtype="bfloat16"))
    static = bench.replace(embedder=dataclasses.replace(bench.embedder, quant="int8-static"))
    serving = launches_of(a=n_layers, b=1, c=2)
    paths = {"explain": counts[0][0], "explain_fused_conv": counts[1][0],
             "train_3_steps": train_launches, **paths}
    for path, pcfg in (("explain_entry_config", entry), ("explain_bench_default", bench),
                       ("explain_int8_static", static)):
        torch.cuda.empty_cache()
        paths[path] = run_explain(torch, pcfg, serving, reps=2, name=path, split=True)[0]
    paths.update(run_int8_attribution(torch, bench))
    torch.cuda.empty_cache()
    frontend_bias_adds(torch, cfg)
    run_tiny_configs(torch)

    # the detector and its data: datagen and embed (the CLI's default
    # configuration), the anyband corpus and the detector fit, the solver
    wav_root = Path(__file__).resolve().parent / "build" / "detector_wavs"
    shutil.rmtree(wav_root, ignore_errors=True)
    paths.update(run_datagen_and_embed(torch, wav_root))
    paths.update(run_detector_corpus(torch, wav_root))
    run_solver_full_width(torch)
    run_tiny_detector(torch)
    # the vocoder over datagen's wavs, then the reduced closed loop
    paths.update(run_vocoder(torch, wav_root))
    run_tiny_vocoded(torch)
    paths.update(run_closed_loop_reduced(torch, wav_root))
    # after every full-width phase (ROADMAP Queue 3: a mask miss seen once there)
    run_tiny_reference(torch)

    for row in rows:
        row["launches_by_path"] = {path: n[row["name"]] for path, n in paths.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if row["launches"] < 1:
            fail(f"kernel {row['name']} was launched by no driven path")
    order = {"attention": 0, "stft": 1, "istft": 2, "ln_gelu": 3, "conv_ln_gelu": 4}
    rows.sort(key=lambda r: order[r["name"]])
    for row in rows:
        # a bound is the least time the card could take; B and C's inputs stay
        # warm in L2 across the timing loop, so a time under it names that
        for key in ("ms", "plain_ms", "library_ms"):
            if row[key] is not None and row[key] < row["bound_ms"]:
                print(f"note: {row['name']} {key} {row[key]:.4f} is below bound_ms "
                      f"{row['bound_ms']:.4f} (inputs warm in L2)")
    if EVENT_TIMED:
        print("device times by CUDA events (no profiler trace showed the kernel): "
              + json.dumps(EVENT_TIMED))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
