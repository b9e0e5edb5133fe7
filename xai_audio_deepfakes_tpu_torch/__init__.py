"""xai_audio_deepfakes_tpu_torch: the PyTorch/CUDA port of
`xai_audio_deepfakes_tpu`, for an NVIDIA H100.

The JAX package beside it is the reference; this package imports nothing of
it, and nothing of JAX. Its layout mirrors the JAX package's:

config    the configuration dataclasses (own copies)
ops       DSP, masking, resampling, waveform alignment and the kernel
          wrappers (attention, STFT/iSTFT, LayerNorm+GELU,
          conv+LayerNorm+GELU), each with its plain PyTorch version and a
          gradient
csrc      the hand-written CUDA kernels, built with nvcc at first use
models    UNet and feature mask decoders, wav2vec2 XLS-R embedder (with the
          HF checkpoint import), LogReg head
pipeline  `ADDvisorPipeline.explain(decoder="unet" | "features")`, end to end
losses    the LMAC loss
train     LMAC training of either mask decoder (`train_addvisor`), checkpoints,
          the detector head's L-BFGS fit (`train_logreg`)
metrics   the LMAC faithfulness metrics, EER, the eval and attribution
          harnesses, mask localisation against a known band
attrib    gradient attribution over the waveform (saliency, input x gradient,
          integrated gradients, SmoothGrad, GradientShap)
data      audio I/O (native, scipy, wave), dataset scanners and the batcher,
          the prefetcher, band-splice datagen and the synthetic corpora
convert   the weight bridge from and to the JAX package's parameter tree

Entry points run on CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"

_LAZY = {
    "ADDvisorPipeline": ("xai_audio_deepfakes_tpu_torch.pipeline.core", "ADDvisorPipeline"),
    "ExplainOutput": ("xai_audio_deepfakes_tpu_torch.pipeline.core", "ExplainOutput"),
    "PipelineConfig": ("xai_audio_deepfakes_tpu_torch.config", "PipelineConfig"),
    "EmbedderConfig": ("xai_audio_deepfakes_tpu_torch.config", "EmbedderConfig"),
    "UNetConfig": ("xai_audio_deepfakes_tpu_torch.config", "UNetConfig"),
    "FeatDecoderConfig": ("xai_audio_deepfakes_tpu_torch.config", "FeatDecoderConfig"),
    "params_from_hf_dir": ("xai_audio_deepfakes_tpu_torch.models.wav2vec2", "params_from_hf_dir"),
    "run_explanation_metrics": ("xai_audio_deepfakes_tpu_torch.metrics.harness",
                                "run_explanation_metrics"),
    "run_attribution_metrics": ("xai_audio_deepfakes_tpu_torch.metrics.harness",
                                "run_attribution_metrics"),
    "MaskingConvention": ("xai_audio_deepfakes_tpu_torch.config", "MaskingConvention"),
    "LabelPolarity": ("xai_audio_deepfakes_tpu_torch.config", "LabelPolarity"),
    "load_jax_params": ("xai_audio_deepfakes_tpu_torch.convert", "load_jax_params"),
    "train_addvisor": ("xai_audio_deepfakes_tpu_torch.train.train_addvisor", "train_addvisor"),
    "make_train_step": ("xai_audio_deepfakes_tpu_torch.train.train_addvisor", "make_train_step"),
    "init_train_state": ("xai_audio_deepfakes_tpu_torch.train.train_addvisor", "init_train_state"),
    "train_detector": ("xai_audio_deepfakes_tpu_torch.train.train_logreg", "train_detector"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
