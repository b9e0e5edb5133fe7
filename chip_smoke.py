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
    E conv+LayerNorm+GELU) against its plain PyTorch version at the main
    path's shapes (8 clips, embedder batch 24), in f32 and in the working
    dtype, each beside its tolerance, and times the kernel, the plain version
    and one PyTorch library call that computes the same function (timed
    only; the port never calls it) by CUDA events; for every kernel also the
    device time per call of the kernel and of the library call from a
    torch.profiler trace (`kernel_device_ms`, `library_device_ms`; D and E
    summed over their shapes, E's with the wrapper's weight-image copy),
    which leave out the host's per-call overhead (a call whose traces show
    no kernel three times over is timed by CUDA events instead and named on
    a line before the `kernels` line); D is held at each of the
    seven frontend shapes in both dtypes and both GELU forms, with its bf16
    elements off by any step and by more than one step (at most 0.1%), and
    timed layer by layer (ms, device ms, GB/s against 3.35 TB/s, beside the
    library's), with ptxas' registers and spills of its instantiations;
 4. holds the backward of A, C, D and E (forward through the kernel, backward
    by recomputation) against autograd through the plain version, at the
    training step's shapes (2 clips);
 5. runs `ADDvisorPipeline.explain(decoder="unet")` at the full width of the
    XLS-R-2B truncation (bf16 embedder, default UNet) on 8 seeded clips with
    random weights from a seeded torch.Generator, checks shapes, finiteness
    and probabilities in (0, 1), counts the kernel launches of one explain
    (A 9, B 1, C 2, D 7) and prints clips/s; then the same with
    `fused_conv=True` (A 9, B 1, C 2, D 1, E 6), whose probabilities must
    agree with the first run's within 0.05;
 6. takes LMAC training steps of the UNet decoder at full width and depth
    (bf16 embedder with both fused frontend kernels, f32 UNet, 2 clips):
    launches per step A 27, B 1, C 2, D 3, E 18, finite losses, loss weights
    renormalised to sum 3, decoder changed, embedder bit-identical; prints
    step ms, its forward / backward / optimiser split and peak memory;
 7. runs a tiny f32 explain and a tiny f32 training step on the card and on
    the CPU with the same weights and compares them (mask 1e-5, waveforms
    2e-4, probabilities 1e-4; losses 1e-4, decoder gradients 1e-3 of their
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
 9. prints the `kernels` JSON line and, last, the device line. A kernel's
    `launches` are those of every driven path together (five explains and
    the counted training steps), each path counted from zero and named in
    `launches_by_path`; its `body` names the design that ran.

Any failed phase exits non-zero without the last line. Without CUDA it exits
1 before printing anything.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

BATCH = 8  # clips per explain; the embedder runs 3 * BATCH
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
    import shutil

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


def check_attention(torch, cfg, rows: list) -> None:
    from xai_audio_deepfakes_tpu_torch.ops.attention import attention, attention_plain

    e = cfg.embedder
    b, t, nh, hd, hdp = 3 * BATCH, cfg.audio.num_frames(cfg.stft), e.num_heads, 120, 128
    g = torch.Generator(device="cuda").manual_seed(1)
    qkv = []
    for i in range(3):
        x = torch.zeros(b, t, nh, hdp, device="cuda")
        x[..., :hd] = torch.randn(b, t, nh, hd, device="cuda", generator=g)
        if i == 0:
            x *= hd**-0.5
        qkv.append(x.reshape(b, t, nh * hdp))
    errs = {}
    for dt, atol, rtol in ((torch.float32, 1e-5, 0.0), (torch.bfloat16, 1e-2, 1e-2)):
        q, k, v = (x.to(dt) for x in qkv)
        out = attention(q, k, v, nh)
        torch.cuda.synchronize()
        errs[dt] = check_close(f"A attention {dt}", out, attention_plain(q, k, v, nh), atol, rtol)
        pad = out.reshape(b, t, nh, hdp)[..., hd:]
        if bool(pad.any()):
            fail("A attention: pad lanes are not exactly zero")
    q, k, v = (x.to(torch.bfloat16) for x in qkv)
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
    from xai_audio_deepfakes_tpu_torch.ops.cuda_stft import istft, stft
    from xai_audio_deepfakes_tpu_torch.ops.stft import (
        device_constant,
        istft_plain,
        stft_plain,
    )

    sc, n = cfg.stft, cfg.audio.num_samples
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(BATCH, n, device="cuda", generator=g) * 0.3
    re, im = stft(x, sc)
    torch.cuda.synchronize()
    re_p, im_p = stft_plain(x, sc)
    err = max(check_close("B stft re", re, re_p, 2e-4), check_close("B stft im", im, im_p, 2e-4))
    t = re.shape[-1]
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
                     library_device_ms=kernel_device_ms(stft_lib),
                     body="radix-8 Stockham FFT of the even/odd-packed frame in shared memory, "
                     "split step, reflect pad folded into the read"))

    mask = torch.rand(re.shape, device="cuda", generator=g)
    re_m, im_m = (re_p * mask).contiguous(), (im_p * mask).contiguous()
    y = istft(re_m, im_m, sc, n)
    torch.cuda.synchronize()
    err = check_close("C istft", y, istft_plain(re_m, im_m, sc, n), 2e-4)
    # randn spectra, as a gradient's: Im[0] and Im[M] non-zero, which the
    # plain version's bases ignore
    re_r, im_r = (torch.randn(re.shape, device="cuda", generator=g) for _ in range(2))
    err = max(err, check_close("C istft, randn spectra", istft(re_r, im_r, sc, n),
                               istft_plain(re_r, im_r, sc, n), 2e-4))
    spec = torch.complex(re_m, im_m)
    def istft_lib():
        return torch.istft(spec, sc.n_fft, sc.hop_length, sc.n_fft, win, center=True, length=n)

    lib = time_ms(istft_lib)
    # per frame the inverse FFT and window, plus overlap-add and envelope
    # division per output sample
    bnd, by = bound_ms(nbytes, ops + 2 * BATCH * n, "float32")
    rows.append(dict(name="istft", route="cuda", source="xai_audio_deepfakes_tpu_torch/csrc/istft.cu",
                     replaces="xai_audio_deepfakes_tpu/ops/pallas_stft.py:210",
                     max_abs_err=err, ms=time_ms(lambda: istft(re_m, im_m, sc, n)),
                     plain_ms=time_ms(lambda: istft_plain(re_m, im_m, sc, n)),
                     bound_ms=bnd, bound_by=by, library_ms=lib,
                     shape=[BATCH, sc.num_bins, t], dtype="float32",
                     kernel_device_ms=kernel_device_ms(lambda: istft(re_m, im_m, sc, n),
                                                       "istft_fft_kernel"),
                     library_device_ms=kernel_device_ms(istft_lib),
                     body="inverse real FFT (half-length pack, radix-8 Stockham core shared "
                     "with B) of the frames touching each 8-hop span, windowed overlap-add "
                     "gathered in shared memory, envelope, trim, crop"))


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
    b, c, eps = 3 * BATCH, e.conv_dim[0], e.layer_norm_eps
    g = torch.Generator(device="cuda").manual_seed(3)
    scale = 1.0 + 0.1 * torch.randn(c, device="cuda", generator=g)
    bias = 0.1 * torch.randn(c, device="cuda", generator=g)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_share = flip_share = 0.0
    plain = lib = lib_dev = 0.0
    by_layer, dev_by_layer, gbs_by_layer, lib_dev_by_layer = [], [], [], []
    for length in frontend_lengths(cfg):
        x32 = torch.randn(b, c, length, device="cuda", generator=g) * 2.0 + 0.5
        for dt, atol, rtol in ((torch.float32, 2e-5, 0.0), (torch.bfloat16, 1e-2, 1e-2)):
            x = x32.to(dt)
            for form in ("exact", "tanh"):
                out = ln_gelu_(x.clone(), scale, bias, eps, form)
                torch.cuda.synchronize()
                want = ln_gelu_plain(x, scale, bias, eps, form)
                errs[dt] = max(errs[dt], check_close(
                    f"D ln_gelu {dt} {form} L={length}", out, want, atol, rtol))
                if dt == torch.bfloat16:
                    steps = bf16_steps(torch, out, want)
                    share = float((steps > 1).float().mean())
                    worst_share = max(worst_share, share)
                    flip_share = max(flip_share, float((steps > 0).float().mean()))
                    if share > 1e-3:
                        fail(f"D ln_gelu: {share:.2e} of the elements are more than one bf16 step off")
                del out, want
        x = x32.to(torch.bfloat16)
        del x32
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
    b, c, eps = 3 * BATCH, e.conv_dim[0], e.layer_norm_eps
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
                f"E conv_ln_gelu {dt} k={k} L={l_in}", out, want, atol, rtol))
            if dt == torch.bfloat16:
                off = (out.float() - want.float()).abs() > 1e-2 + 1e-2 * want.float().abs()
                share = float(off.float().mean())
                worst_share = max(worst_share, share)
                print(f"    more than one bf16 step off: {share:.2e} of the elements (at most 1e-3)")
                if share > 1e-3:
                    fail("E conv_ln_gelu: too many elements are more than one bf16 step off")
            del out, want
        # x, w, ... are now the bf16 inputs of this layer
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


def stage_split(torch, pipe, wav) -> dict:
    """Device ms of each stage of one explain on its own (CUDA events, 5
    calls after a warm-up): spectrogram, predict_mask, masking and the two
    iSTFTs, and the 3B-batch embedder as frontend, projection + positional
    conv, and the transformer layers (with the calibrated scales under
    int8-static)."""
    from xai_audio_deepfakes_tpu_torch.ops.masking import apply_mask, remask_complex
    from xai_audio_deepfakes_tpu_torch.ops.normalize import zero_mean_unit_var_norm

    enc, cfg = pipe.encoder, pipe.cfg
    static = cfg.embedder.quant == "int8-static" and pipe.quant_scales is not None
    with torch.inference_mode():
        out = pipe.explain(wav)
        _, _, mag, phase = pipe.spectrogram(wav)
        norm = zero_mean_unit_var_norm(torch.cat([wav, out.relevant_wav, out.irrelevant_wav]))
        fe = enc.feature_encoder(norm)
        proj = enc.feature_projection(fe)
        x = proj + enc.pos_conv(proj)

        def layers():
            y = x
            for i, layer in enumerate(enc.layers):
                y = layer(y, {k: v[i] for k, v in pipe.quant_scales.items()} if static else None)

        def masked_istfts():
            rel, irr = apply_mask(out.mask, mag, cfg.masking)
            pipe.istft(*remask_complex(rel, phase))
            pipe.istft(*remask_complex(irr, phase))

        unet = f"predict_mask (UNet {cfg.unet.dtype}{', int8' if cfg.unet.quant != 'none' else ''})"
        return {
            "spectrogram": time_ms(lambda: pipe.spectrogram(wav), iters=5),
            unet: time_ms(lambda: pipe.predict_mask(mag), iters=5),
            "masking + 2 iSTFT": time_ms(masked_istfts, iters=5),
            "embedder: frontend": time_ms(lambda: enc.feature_encoder(norm), iters=5),
            "embedder: projection + pos conv": time_ms(
                lambda: proj + enc.pos_conv(enc.feature_projection(fe)), iters=5),
            f"embedder: {len(enc.layers)} layers": time_ms(layers, iters=5),
        }


def run_explain(torch, cfg, want: dict, reps: int, name: str = "", split: bool = False):
    """One counted explain at full width and `reps` timed ones; returns the
    launch counts and the three probabilities of every clip. Under
    int8-static the pipeline is first calibrated on 16 seeded clips; with
    `split` the stage split of `stage_split` is printed."""
    import numpy as np

    from xai_audio_deepfakes_tpu_torch.ops import _cuda
    from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline

    t0 = time.perf_counter()
    pipe = ADDvisorPipeline(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"pipeline built with random weights in {time.perf_counter() - t0:.1f} s")
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
    pipe.explain(wav_t)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _cuda.reset_launches()
    t0 = time.perf_counter()
    out = pipe.explain(wav_t)
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
        pipe.explain(wav_t)
    torch.cuda.synchronize()
    steady = (time.perf_counter() - t0) / reps
    e, u = cfg.embedder, cfg.unet
    name = name or f"fused_conv={e.fused_conv}"
    print(f"explain B={BATCH} {name} (embedder {e.dtype}, quant {e.quant}, gelu {e.gelu}, "
          f"fused_ln_gelu {e.fused_ln_gelu}, fused_conv {e.fused_conv}; UNet {u.dtype}): "
          f"counted run {first * 1e3:.1f} ms, steady {steady * 1e3:.1f} ms, "
          f"{BATCH / steady:.2f} clips/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if split:
        print(f"  stage split ({name}), device ms: " + json.dumps(
            {k: round(v, 3) for k, v in stage_split(torch, pipe, wav_t).items()}))
    probs = torch.cat([out.probs_clean, out.probs_relevant, out.probs_irrelevant])
    return launches, probs.flatten().cpu()


def run_tiny_reference(torch) -> None:
    """Tiny f32 explain on the card against the same weights on the CPU."""
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
    out_gpu, out_cpu = gpu.explain(wav.cuda()), cpu.explain(wav)
    torch.cuda.synchronize()
    for name, atol in (("mask", 1e-5), ("relevant_wav", 2e-4), ("irrelevant_wav", 2e-4),
                       ("probs_clean", 1e-4), ("probs_relevant", 1e-4), ("probs_irrelevant", 1e-4)):
        check_close(f"tiny explain {name}", getattr(out_gpu, name).cpu(), getattr(out_cpu, name), atol)


def run_training(torch, cfg) -> dict:
    """LMAC training steps of the UNet decoder at full width and depth on
    seeded noise; returns the launches of the counted steps together."""
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
    return total


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
    torch.cuda.empty_cache()

    n_layers, n_conv = cfg.embedder.num_layers, len(cfg.embedder.conv_dim)
    counts = [run_explain(torch, cfg, {"attention": n_layers, "stft": 1, "istft": 2,
                                       "ln_gelu": n_conv, "conv_ln_gelu": 0}, reps=2)]
    torch.cuda.empty_cache()
    counts.append(run_explain(torch, fused, {"attention": n_layers, "stft": 1, "istft": 2,
                                             "ln_gelu": 1, "conv_ln_gelu": n_conv - 1}, reps=2))
    # same seed, same weights: the two frontends differ by bf16 rounding only
    check_close("explain fused_conv probabilities vs default", counts[1][1], counts[0][1], 0.05)
    torch.cuda.empty_cache()
    train_launches = run_training(torch, fused)
    torch.cuda.empty_cache()
    run_tiny_reference(torch)
    run_tiny_training(torch)

    # the JAX package's serving configurations: the entry point's (bf16,
    # fused_ln_gelu False) and bench.py's default (bf16, int8, tanh, bf16
    # UNet), then the same calibrated (int8-static); no frontend kernel runs
    entry = PipelineConfig(embedder=EmbedderConfig(dtype="bfloat16"))
    bench = PipelineConfig(embedder=EmbedderConfig(dtype="bfloat16", quant="int8", gelu="tanh"),
                           unet=UNetConfig(dtype="bfloat16"))
    static = bench.replace(embedder=dataclasses.replace(bench.embedder, quant="int8-static"))
    serving = {"attention": n_layers, "stft": 1, "istft": 2, "ln_gelu": 0, "conv_ln_gelu": 0}
    paths = {"explain": counts[0][0], "explain_fused_conv": counts[1][0],
             "train_3_steps": train_launches}
    for path, pcfg in (("explain_entry_config", entry), ("explain_bench_default", bench),
                       ("explain_int8_static", static)):
        torch.cuda.empty_cache()
        paths[path] = run_explain(torch, pcfg, serving, reps=2, name=path, split=True)[0]
    torch.cuda.empty_cache()
    frontend_bias_adds(torch, cfg)
    run_tiny_configs(torch)

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
