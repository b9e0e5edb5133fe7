"""Configuration of the PyTorch/CUDA port.

Field names and defaults are those of `xai_audio_deepfakes_tpu/config.py`, so
a configuration reads the same on both sides. The port keeps its own copies
(it imports nothing of the JAX package). `PipelineConfig` carries the
sub-configs of the explanation path (`explain(decoder="unet")`) and of LMAC
training of the UNet decoder (`loss`, `train`); the mel, vocoder,
feature-decoder and mesh configs arrive with the slices that use them
(ROADMAP.md, Queue 1).

The port has one formulation of each op: its hand-written kernels on the
card and their plain PyTorch versions, with the same order of operations,
on the CPU. The JAX package's implementation switches are therefore
honoured only where their values name that formulation, and
`check_supported` raises `NotImplementedError` on any other value:

- `STFTConfig.use_pallas`: both values compute the same f32 DFT; accepted.
- `STFTConfig.precision`: the MXU pass count of the TPU's DFT matmuls. The
  JAX package's CPU path ignores it and computes in f32, as the port does
  for "high" and "highest". "default" (one bf16 pass) raises.
- `EmbedderConfig.fused_attention=False` selects `attention_reference`'s
  order (p normalised, then cast), which differs from the kernel's in bf16:
  raises.
- `EmbedderConfig.fused_ln_gelu=False` computes GELU in the compute dtype.
  The same in f32; in bf16 it differs from the kernel's f32 GELU: raises.
- `EmbedderConfig.fused_conv=True` takes kernel E (conv + LayerNorm + GELU in
  one pass) for the frontend layers it covers; accepted. In f32 it equals
  the unfused path; in bf16 it has the kernel's cast points.
- `EmbedderConfig.fused_interpret` runs the Pallas kernels in interpret
  mode, which is the formulation the port has; accepted.
- `EmbedderConfig.remat=True` checkpoints each transformer layer
  (`torch.utils.checkpoint`), which is `remat_policy="full"`; "dots" raises.
- `TrainConfig.target_quant` other than "none" raises (ROADMAP Queue 1
  item 6, the int8 variants); `target_gelu="tanh"` is accepted.

Fields that select behaviour this slice does not implement raise
`NotImplementedError` likewise.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass


class MaskingConvention(str, enum.Enum):
    """How the predicted mask is applied to the STFT magnitude.

    LINEAR: relevant = mask * mag                  (training convention)
    LOG1P:  relevant = expm1(mask * log1p(mag))    (eval/serving convention)
    """

    LINEAR = "linear"
    LOG1P = "log1p"


class LabelPolarity(str, enum.Enum):
    """Which class the positive detector logit means."""

    MANIPULATED_IS_ONE = "manipulated_is_one"
    REAL_IS_ONE = "real_is_one"


@dataclass(frozen=True)
class STFTConfig:
    """n_fft 1024, hop 322, rectangular 644-sample window centred in n_fft,
    reflect padding: 1 + 80000 // 322 = 249 frames, aligned with the 249
    embedder frames."""

    sample_rate: int = 16000
    n_fft: int = 1024
    hop_length: int = 322
    win_length: int = 644
    window: str = "rect"  # "rect" | "hann"
    center: bool = True
    pad_mode: str = "reflect"
    use_pallas: bool = False  # JAX-side kernel switch; see module docstring
    precision: str = "high"  # "high" | "highest": the port computes in f32

    @property
    def num_bins(self) -> int:
        return self.n_fft // 2 + 1


@dataclass(frozen=True)
class AudioConfig:
    """Fixed-length clips: 5 s at 16 kHz, 80000 samples."""

    sample_rate: int = 16000
    clip_seconds: float = 5.0

    @property
    def num_samples(self) -> int:
        return int(self.clip_seconds * self.sample_rate)

    def num_frames(self, stft: STFTConfig) -> int:
        assert stft.center
        return 1 + self.num_samples // stft.hop_length


@dataclass(frozen=True)
class EmbedderConfig:
    """Truncated wav2vec2 XLS-R-2B: hidden 1920, 16 heads, FFN 7680, seven
    conv layers of width 512, readout of hidden_states[9]."""

    hidden_size: int = 1920
    num_layers: int = 9
    num_heads: int = 16
    intermediate_size: int = 7680
    conv_dim: tuple = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    feat_extract_norm: str = "layer"
    do_stable_layer_norm: bool = True
    conv_bias: bool = True
    output_layer: int = 9
    final_layer_norm: bool = False
    remat: bool = False
    remat_policy: str = "full"
    scan_layers: bool = False
    dtype: str = "float32"  # compute dtype: "float32" | "bfloat16"
    quant: str = "none"
    quant_conv: str = "none"
    fused_interpret: bool = False
    fused_conv: bool = False
    fused_ln_gelu: bool = False
    fused_attention: bool = True
    gelu: str = "exact"  # "exact" | "tanh"

    @staticmethod
    def tiny() -> "EmbedderConfig":
        return EmbedderConfig(
            hidden_size=32,
            num_layers=3,
            num_heads=2,
            intermediate_size=64,
            conv_dim=(8, 8, 8),
            conv_kernel=(10, 3, 2),
            conv_stride=(5, 2, 2),
            num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=2,
            output_layer=2,
        )


@dataclass(frozen=True)
class UNetConfig:
    """Magnitude mask decoder; input is the STFT magnitude cropped from
    (513, 249) to (freq_bins, frames) so that every skip concat closes."""

    freq_bins: int = 512
    frames: int = 248
    base_channels: int = 32
    leaky_slope: float = 0.2
    dtype: str = "float32"
    quant: str = "none"


@dataclass(frozen=True)
class LossConfig:
    """LMAC loss: learnable softplus weights over [l_in, l_out, l1], raw
    init [3.0, 0.5, 3.0]; optional TV regulariser (off at reg_w_tv = 0).
    `l1_scale` multiplies the L1 sparsity term; 1.0 is the reference formula."""

    w_init: tuple = (3.0, 0.5, 3.0)
    reg_w_tv: float = 0.0
    masking: MaskingConvention = MaskingConvention.LINEAR
    l1_scale: float = 1.0


@dataclass(frozen=True)
class TrainConfig:
    """Trainer: Adam lr 3e-5 for the mask decoder, Adam lr 1e-4 for the loss
    weights, post-step renorm of w to sum = len(w).

    The epoch loop keeps per-step losses on the device and folds them once
    per epoch; a probe every `nan_check_every` steps (0 = epoch end only)
    bounds how long a diverged run continues. `target_gelu` selects the GELU
    of the gradient-free clean embed that produces the target. With
    `freeze_l1_weight` the L1 weight takes no gradient step and is left out
    of the renorm, which then keeps the other weights at sum len(w) - 1.
    `checkpoint_dir`, `artifact_dir`, `seed` and `donate_buffers` are read by
    the CLI of the JAX package and kept so that a configuration reads the
    same on both sides."""

    model_lr: float = 3e-5
    loss_w_lr: float = 1e-4
    batch_size: int = 2
    num_epochs: int = 1000
    seed: int = 0
    renorm_loss_w: bool = True
    nan_check_every: int = 16
    checkpoint_dir: str = "ckpts"
    artifact_dir: str = "explanations"
    checkpoint_every: int = 1
    donate_buffers: bool = True
    target_quant: str = "none"  # "none" | "int8" (int8 not ported)
    target_gelu: str = "exact"  # "exact" | "tanh"
    freeze_l1_weight: bool = False


@dataclass(frozen=True)
class PipelineConfig:
    audio: AudioConfig = AudioConfig()
    stft: STFTConfig = STFTConfig()
    embedder: EmbedderConfig = EmbedderConfig()
    unet: UNetConfig = UNetConfig()
    loss: LossConfig = LossConfig()
    train: TrainConfig = TrainConfig()
    masking: MaskingConvention = MaskingConvention.LOG1P
    polarity: LabelPolarity = LabelPolarity.MANIPULATED_IS_ONE

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def check_supported(cfg: PipelineConfig) -> None:
    """Raise on configuration this slice of the port does not implement."""
    e, u = cfg.embedder, cfg.unet
    todo = {
        "STFTConfig.precision=default": (cfg.stft.precision == "default", "Queue 1 item 2"),
        "EmbedderConfig.fused_attention=False": (not e.fused_attention, "Queue 1 item 4"),
        "EmbedderConfig.fused_ln_gelu=False with bfloat16": (
            e.dtype == "bfloat16" and not e.fused_ln_gelu, "Queue 1 item 4"),
        "EmbedderConfig.quant": (e.quant != "none", "Queue 1 item 6"),
        "EmbedderConfig.quant_conv": (e.quant_conv != "none", "Queue 1 item 6"),
        "UNetConfig.quant": (u.quant != "none", "Queue 1 item 6"),
        "EmbedderConfig.scan_layers": (e.scan_layers, "Queue 1 item 4"),
        "EmbedderConfig.remat_policy other than full": (
            e.remat and e.remat_policy != "full", "Queue 1 item 7"),
        "TrainConfig.target_quant": (cfg.train.target_quant != "none", "Queue 1 item 6"),
        "UNetConfig.dtype=bfloat16": (u.dtype != "float32", "Queue 1 item 3"),
    }
    for name, (unsupported, item) in todo.items():
        if unsupported:
            raise NotImplementedError(
                f"{name} is not ported yet (ROADMAP.md {item})"
            )
    if cfg.stft.precision not in ("default", "high", "highest"):
        raise ValueError(f"unknown STFT precision: {cfg.stft.precision!r}")
    if e.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown embedder dtype: {e.dtype!r}")
    for gelu in (e.gelu, cfg.train.target_gelu):
        if gelu not in ("exact", "tanh"):
            raise ValueError(f"unknown gelu: {gelu!r}")
