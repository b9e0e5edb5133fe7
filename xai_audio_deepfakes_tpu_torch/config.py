"""Configuration of the PyTorch/CUDA port.

Field names and defaults are those of `xai_audio_deepfakes_tpu/config.py`, so
a configuration reads the same on both sides. The port keeps its own copies
(it imports nothing of the JAX package). `PipelineConfig` carries the
sub-configs of the explanation path (`explain`, with the UNet or the
feature decoder), of LMAC training of either decoder (`loss`, `train`) and
of the vocoder path (`mel`, `hifigan`); the mesh config arrives with the
parallel layer (ROADMAP.md, Queue 1 item 11).

The JAX package's implementation switches select formulations, and the
port runs each formulation it accepts with the same cast points: its
hand-written kernels on the card and their plain PyTorch versions, with the
same order of operations, on the CPU; the XLA paths of the JAX package
(unfused LayerNorm and GELU, einsum attention, int8 products) as plain
PyTorch on both.

- `STFTConfig.use_pallas`: both values compute the same f32 DFT; accepted.
- `STFTConfig.precision`: the MXU pass count of the TPU's DFT matmuls. The
  JAX package's CPU path ignores it and computes every precision in exact
  f32; so does the port, for all three values ("default", one bf16 pass on
  the TPU, has no CPU reference to be held against).
- `EmbedderConfig.fused_attention`: True takes the head-padded projections
  and kernel A; False the unpadded projections and `attention_reference`'s
  einsum order (p normalised in f32, then cast).
- `EmbedderConfig.fused_ln_gelu`: True takes kernel D's cast points (GELU in
  f32) at the frontend layers whose channel count is a multiple of 128, as
  the JAX package takes its kernel there; every other layer, and every
  layer with False, runs the f32-statistics LayerNorm and GELU in the
  compute dtype.
- `EmbedderConfig.fused_conv=True` takes kernel E (conv + LayerNorm + GELU in
  one pass) for the frontend layers it covers. In f32 it equals the unfused
  path; in bf16 it has the kernel's cast points.
- `EmbedderConfig.fused_interpret` runs the Pallas kernels in interpret
  mode, which is the formulation the port has; accepted.
- `EmbedderConfig.quant` "int8" / "int8-static", `quant_conv="int8"` and
  `UNetConfig.quant="int8"`: the int8 serving paths (`ops/quant.py`);
  int8-static uses the scales of `ADDvisorPipeline.calibrate_quant`.
- `UNetConfig.dtype="bfloat16"`: bf16 convolutions with f32 BatchNorm and
  f32 parameters, for serving and training (the casts carry the gradient).
- `EmbedderConfig.remat=True` checkpoints each transformer layer
  (`torch.utils.checkpoint`): `remat_policy="full"` recomputes the whole
  layer in the backward pass, "dots" keeps the products' outputs (`mm`,
  `addmm`, `bmm`, `_int_mm`) and recomputes the rest, as
  `jax.checkpoint_policies.checkpoint_dots` keeps every `dot_general`.
- `EmbedderConfig.scan_layers` selects the JAX package's stacked parameter
  layout (`layers/layer`, a leading [n_layers] axis), which
  `convert.load_encoder` and `params_from_hf_state_dict` read and write; the
  numbers are the unrolled encoder's, and the port's layer loop stays a
  loop.
- `TrainConfig.target_quant="int8"` and `target_gelu="tanh"` run the
  gradient-free target embed through a second encoder module over the same
  weights (`Wav2Vec2Encoder.with_config`): dynamic per-token int8 products,
  as `quant="int8"` serves.
- `HiFiGANConfig.dtype="bfloat16"`: the generator's convolutions in bf16
  (bias added in bf16), tanh in f32.

`check_supported` raises ValueError on a value that selects no
formulation. `MelConfig.norm` and `mel_scale` are read as in the JAX package:
the filterbank is slaney whatever they say.
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


def manipulated_probability(prob, polarity: "LabelPolarity | str"):
    """The detector's sigmoid output P(class 1) as P(manipulated) under
    `polarity`. Every decision on "manipulated" (the attribution harness's
    count) goes through this one mapping."""
    if LabelPolarity(polarity) is LabelPolarity.MANIPULATED_IS_ONE:
        return prob
    return 1.0 - prob


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
    precision: str = "high"  # "default" | "high" | "highest": all exact f32 here

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
class MelConfig:
    """Mel transform of the vocoder path: hop 256, win 1024 (periodic Hann),
    80 mels, f_max 8 kHz, slaney norm and scale, power 1, log compression
    with a 1e-5 clip."""

    sample_rate: int = 16000
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    f_min: float = 0.0
    f_max: float = 8000.0
    power: float = 1.0
    norm: str = "slaney"
    mel_scale: str = "slaney"
    compression: bool = True
    compression_clip: float = 1e-5


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
class FeatDecoderConfig:
    """Feature-input mask decoder: SSL features [B, T, feature_dim] -> a
    (freq_bins x T) mask, T the 249 embedder frames that align with the 249
    STFT frames. `temporal_blocks` residual k5 convs over the frames, then
    `attn_layers` pre-LN self-attention + FFN blocks (`attn_heads` heads)."""

    feature_dim: int = 1920
    freq_bins: int = 512
    frames: int = 249
    hidden: int = 512
    dtype: str = "float32"
    temporal_blocks: int = 2
    attn_layers: int = 0
    attn_heads: int = 8


@dataclass(frozen=True)
class HiFiGANConfig:
    """HiFi-GAN V1 generator with 256x upsampling (rates 8, 8, 2, 2), to
    match the hop-256 mel frontend: 16 kHz speech from 80 mels."""

    in_channels: int = 80
    upsample_initial_channel: int = 512
    upsample_rates: tuple = (8, 8, 2, 2)
    upsample_kernel_sizes: tuple = (16, 16, 4, 4)
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilations: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    leaky_slope: float = 0.1
    dtype: str = "float32"


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
    target_quant: str = "none"  # "none" | "int8"
    target_gelu: str = "exact"  # "exact" | "tanh"
    freeze_l1_weight: bool = False


@dataclass(frozen=True)
class PipelineConfig:
    audio: AudioConfig = AudioConfig()
    stft: STFTConfig = STFTConfig()
    mel: MelConfig = MelConfig()
    embedder: EmbedderConfig = EmbedderConfig()
    unet: UNetConfig = UNetConfig()
    feat_decoder: FeatDecoderConfig = FeatDecoderConfig()
    hifigan: HiFiGANConfig = HiFiGANConfig()
    loss: LossConfig = LossConfig()
    train: TrainConfig = TrainConfig()
    masking: MaskingConvention = MaskingConvention.LOG1P
    polarity: LabelPolarity = LabelPolarity.MANIPULATED_IS_ONE

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def check_supported(cfg: PipelineConfig) -> None:
    """Raise on a value that selects no formulation."""
    e, u = cfg.embedder, cfg.unet
    choices = {
        "STFT precision": (cfg.stft.precision, ("default", "high", "highest")),
        "embedder dtype": (e.dtype, ("float32", "bfloat16")),
        "UNet dtype": (u.dtype, ("float32", "bfloat16")),
        "feature decoder dtype": (cfg.feat_decoder.dtype, ("float32", "bfloat16")),
        "remat_policy": (e.remat_policy, ("full", "dots")),
        "embedder quant": (e.quant, ("none", "int8", "int8-static")),
        "embedder quant_conv": (e.quant_conv, ("none", "int8")),
        "UNet quant": (u.quant, ("none", "int8")),
        "gelu": (e.gelu, ("exact", "tanh")),
        "target gelu": (cfg.train.target_gelu, ("exact", "tanh")),
        "target quant": (cfg.train.target_quant, ("none", "int8")),
        "HiFi-GAN dtype": (cfg.hifigan.dtype, ("float32", "bfloat16")),
    }
    for name, (value, allowed) in choices.items():
        if value not in allowed:
            raise ValueError(f"unknown {name}: {value!r}")
