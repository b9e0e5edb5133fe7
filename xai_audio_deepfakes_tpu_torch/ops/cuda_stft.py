"""STFT and iSTFT kernel wrappers (kernels B and C; the port's counterpart
of `ops/pallas_stft.py`).

CPU tensors take the plain versions in `ops/stft.py`; CUDA tensors launch
`csrc/stft.cu` and `csrc/istft.cu`. Both kernels work in f32 and share one
shared-memory FFT core (`csrc/fft.cuh`) for a power-of-two n_fft (every
configuration of the repo), with a direct DFT otherwise (`uses_fft`,
`istft_uses_fft`). Kernel B reads the signal itself, the reflect pad folded
into the read; kernel C inverse-transforms the frames that touch each
block's span of output samples and overlap-adds them in shared memory.

Each kernel is a registered op, `addv::stft` (`stft_op`) and `addv::istft`
(`istft_op`), that takes the STFT configuration as plain numbers and
strings (`_cfg_args`): its CPU implementation is the plain version, its CUDA
implementation the launch, and its fake implementation gives the outputs'
shapes.

Both transforms are linear, so their gradients (`_Stft`, `_Istft`) are the
vjps of the plain versions and need no saved input, as the `bwd`s of
`make_fused_stft` / `make_fused_istft` in the JAX package.
"""

from __future__ import annotations

import torch

from xai_audio_deepfakes_tpu_torch.config import STFTConfig
from xai_audio_deepfakes_tpu_torch.ops import _cuda
from xai_audio_deepfakes_tpu_torch.ops._autograd import needs_grad, recompute_vjp
from xai_audio_deepfakes_tpu_torch.ops.stft import (
    device_constant,
    istft_plain,
    pad_signal,
    stft_plain,
)


class _Stft(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cfg):
        ctx.cfg, ctx.like = cfg, (x.shape, x.device)
        return stft_op(x, *_cfg_args(cfg))

    @staticmethod
    def backward(ctx, g_re, g_im):
        zeros = torch.zeros(ctx.like[0], device=ctx.like[1])
        (gx,) = recompute_vjp(lambda x: stft_plain(x, ctx.cfg), (zeros,), (True,), (g_re, g_im))
        return gx, None


class _Istft(torch.autograd.Function):
    @staticmethod
    def forward(ctx, real, imag, cfg, length):
        ctx.cfg, ctx.length, ctx.like = cfg, length, (real.shape, real.device)
        return istft_op(real, imag, *_cfg_args(cfg), length)

    @staticmethod
    def backward(ctx, grad):
        zeros = torch.zeros(ctx.like[0], device=ctx.like[1])
        g_re, g_im = recompute_vjp(lambda re, im: istft_plain(re, im, ctx.cfg, ctx.length),
                                   (zeros, zeros), ctx.needs_input_grad[:2], grad)
        return g_re, g_im, None, None


def stft(x: torch.Tensor, cfg: STFTConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, L] (or [L]) f32 -> (re, im), each [B, n_fft//2+1, T]."""
    if x.ndim == 1:
        x = x[None]
    if needs_grad(x):
        return _Stft.apply(x, cfg)
    return stft_op(x, *_cfg_args(cfg))


def uses_fft(n_fft: int) -> bool:
    """Whether kernel B takes its FFT body (a power of two up to 8192, as
    `addv_stft_fft` accepts) rather than its direct-DFT body."""
    return 2 <= n_fft <= 8192 and n_fft & (n_fft - 1) == 0


def istft_uses_fft(n_fft: int, hop: int) -> bool:
    """Whether kernel C takes its FFT body (as `addv_istft_fft` accepts: the
    FFT's n_fft, frames that overlap or meet) rather than its direct DFT."""
    return uses_fft(n_fft) and hop <= n_fft


def _cfg_args(cfg: STFTConfig) -> tuple:
    """The fields of `cfg` the ops take, in their order."""
    return cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.window, cfg.center, cfg.pad_mode


def _cfg(n_fft: int, hop_length: int, win_length: int, window: str, center: bool,
         pad_mode: str = "reflect") -> STFTConfig:
    return STFTConfig(n_fft=n_fft, hop_length=hop_length, win_length=win_length,
                      window=window, center=center, pad_mode=pad_mode)


def _num_frames(sig_len: int, n_fft: int, hop: int, center: bool) -> int:
    return 1 + (sig_len + (2 * (n_fft // 2) if center else 0) - n_fft) // hop


@torch.library.custom_op(f"{_cuda.NAMESPACE}::stft", mutates_args=(), device_types="cpu")
def stft_op(x: torch.Tensor, n_fft: int, hop_length: int, win_length: int, window: str,
            center: bool, pad_mode: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B as a registered op, [B, L] -> (re, im) [B, F, T]; on the CPU,
    the plain version."""
    return stft_plain(x, _cfg(n_fft, hop_length, win_length, window, center, pad_mode))


@stft_op.register_fake
def _(x, n_fft, hop_length, win_length, window, center, pad_mode):
    shape = (x.shape[0], n_fft // 2 + 1, _num_frames(x.shape[-1], n_fft, hop_length, center))
    return x.new_empty(shape), x.new_empty(shape)


@stft_op.register_kernel("cuda")
def _stft_cuda(x: torch.Tensor, n_fft: int, hop_length: int, win_length: int, window: str,
               center: bool, pad_mode: str) -> tuple[torch.Tensor, torch.Tensor]:
    cfg = _cfg(n_fft, hop_length, win_length, window, center, pad_mode)
    _cuda.require_cuda("stft", x)
    hop = hop_length
    # the kernel folds a reflect pad into its read; any other pad is made here
    # (and F.pad's reflect mode raises on a signal no longer than the pad)
    pad = n_fft // 2 if cfg.center and cfg.pad_mode == "reflect" and x.shape[-1] > n_fft // 2 else 0
    xs = (x if pad else pad_signal(x, cfg)).contiguous()
    b, sig_len = xs.shape
    if sig_len + 2 * pad < n_fft:
        raise ValueError(f"stft: signal of {x.shape[-1]} samples is shorter than a frame")
    t = 1 + (sig_len + 2 * pad - n_fft) // hop
    win = device_constant("window", x.device, cfg.window, cfg.win_length, n_fft)
    re = torch.empty((b, cfg.num_bins, t), dtype=torch.float32, device=x.device)
    im = torch.empty_like(re)
    lib, stream = _cuda.library(), _cuda.stream_handle(x)
    if uses_fft(n_fft):
        tw = device_constant("twiddle", x.device, n_fft)
        err = lib.addv_stft_fft(xs.data_ptr(), win.data_ptr(), tw.data_ptr(), re.data_ptr(),
                                im.data_ptr(), b, sig_len, pad, t, n_fft, hop, stream)
    else:
        bases = device_constant("dft", x.device, n_fft)
        err = lib.addv_stft(xs.data_ptr(), win.data_ptr(), bases[0].data_ptr(),
                            bases[1].data_ptr(), re.data_ptr(), im.data_ptr(), b, sig_len, pad,
                            t, n_fft, hop, stream)
    _cuda.check(err, "stft")
    _cuda.LAUNCHES["stft"] += 1
    return re, im


def stft_magnitude_phase(x: torch.Tensor, cfg: STFTConfig):
    """(re, im, magnitude, phase), magnitude and phase as torch .abs() and
    .angle() of the complex STFT."""
    re, im = stft(x, cfg)
    return re, im, torch.sqrt(re * re + im * im), torch.atan2(im, re)


def istft(real: torch.Tensor, imag: torch.Tensor, cfg: STFTConfig, length: int) -> torch.Tensor:
    """(re, im) [B, n_fft//2+1, T] f32 -> waveform [B, length]."""
    if real.ndim == 2:
        real, imag = real[None], imag[None]
    if needs_grad(real, imag):
        return _Istft.apply(real, imag, cfg, length)
    return istft_op(real, imag, *_cfg_args(cfg), length)


@torch.library.custom_op(f"{_cuda.NAMESPACE}::istft", mutates_args=(), device_types="cpu")
def istft_op(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop_length: int,
             win_length: int, window: str, center: bool, pad_mode: str,
             length: int) -> torch.Tensor:
    """Kernel C as a registered op, (re, im) [B, F, T] -> [B, length]; on the
    CPU, the plain version."""
    cfg = _cfg(n_fft, hop_length, win_length, window, center, pad_mode)
    return _cuda.fresh(istft_plain(real, imag, cfg, length))


@istft_op.register_fake
def _(real, imag, n_fft, hop_length, win_length, window, center, pad_mode, length):
    return real.new_empty((real.shape[0], length))


@istft_op.register_kernel("cuda")
def _istft_cuda(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop_length: int,
                win_length: int, window: str, center: bool, pad_mode: str,
                length: int) -> torch.Tensor:
    cfg = _cfg(n_fft, hop_length, win_length, window, center, pad_mode)
    real, imag = real.contiguous(), imag.contiguous()
    _cuda.require_cuda("istft", real, imag)
    b, f, t = real.shape
    hop = hop_length
    if imag.shape != real.shape or f != cfg.num_bins:
        raise ValueError(f"istft: re {tuple(real.shape)}, im {tuple(imag.shape)}")
    win = device_constant("window", real.device, cfg.window, cfg.win_length, n_fft)
    env = device_constant("envelope", real.device, t, n_fft, hop, cfg.window, cfg.win_length)
    y = torch.empty((b, length), dtype=torch.float32, device=real.device)
    lib, stream = _cuda.library(), _cuda.stream_handle(real)
    if istft_uses_fft(n_fft, hop):
        tw = device_constant("twiddle", real.device, n_fft)
        err = lib.addv_istft_fft(real.data_ptr(), imag.data_ptr(), win.data_ptr(), tw.data_ptr(),
                                 env.data_ptr(), y.data_ptr(), b, t, n_fft, hop,
                                 int(cfg.center), length, stream)
    else:
        bases = device_constant("idft", real.device, n_fft)
        err = lib.addv_istft(real.data_ptr(), imag.data_ptr(), bases[0].data_ptr(),
                             bases[1].data_ptr(), win.data_ptr(), env.data_ptr(), y.data_ptr(),
                             b, t, n_fft, hop, int(cfg.center), length, stream)
    _cuda.check(err, "istft")
    _cuda.LAUNCHES["istft"] += 1
    return y
