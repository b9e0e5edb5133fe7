"""End-to-end explanation pipeline (port of `pipeline/core.py`):
wav -> STFT -> UNet mask -> masked iSTFTs -> one 3B-batch embedder pass ->
LogReg -> three probabilities; or, with the feature decoder, wav -> one
B-batch embed whose features give the mask and the clean probability ->
masked iSTFTs -> one 2B-batch embed of the masked clips; and the listenable
path, wav -> log-mel (kernel B) -> HiFi-GAN -> wav (`vocode`), after an
explain (`explain_vocoded`).

The JAX pipeline is a frozen bundle of module definitions whose stages are
pure functions of (params, arrays). Here the pipeline owns its modules and
their weights; `convert.load_jax_params` sets them from a JAX parameter tree,
and a fresh pipeline has random weights drawn from a seeded torch.Generator
(embedder, UNet, LogReg head, the feature decoder, then, at its first use,
the HiFi-GAN generator, so that the modules drawn before each keep their
weights). The embedder and the LogReg head are
frozen; a mask decoder (`unet` or `feat_decoder`) is what training updates,
in place.

Every serving entry point runs under `torch.inference_mode()`. The stages
the trainer differentiates through (`embed`, `stft_stage`, `istft_stage`)
are the same code without that decorator.

With `EmbedderConfig.quant="int8-static"` the pipeline holds the calibrated
activation scales as its state (`quant_scales`, {site: [n_layers, C_site]}),
set by `calibrate_quant` or `convert.load_quant_scales`; until then the
embedder quantizes with dynamic per-token scales, as the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from xai_audio_deepfakes_tpu_torch.config import (
    MaskingConvention,
    PipelineConfig,
    check_supported,
)
from xai_audio_deepfakes_tpu_torch.device import resolve_device
from xai_audio_deepfakes_tpu_torch.models.feat_decoder import FeatureMaskDecoder
from xai_audio_deepfakes_tpu_torch.models.hifigan import HiFiGANGenerator, init_hifigan_
from xai_audio_deepfakes_tpu_torch.models.logreg import logreg_apply, logreg_init
from xai_audio_deepfakes_tpu_torch.models.unet import UNetMaskDecoder, init_unet_
from xai_audio_deepfakes_tpu_torch.models.wav2vec2 import Wav2Vec2Encoder
from xai_audio_deepfakes_tpu_torch.ops.cuda_stft import istft, stft_magnitude_phase
from xai_audio_deepfakes_tpu_torch.ops.masking import (
    apply_mask,
    crop_spec,
    pad_mask_to_spec,
    remask_complex,
)
from xai_audio_deepfakes_tpu_torch.ops.mel import mel_spectrogram
from xai_audio_deepfakes_tpu_torch.ops.normalize import zero_mean_unit_var_norm
from xai_audio_deepfakes_tpu_torch.ops.quant import per_127


class ExplainOutput(NamedTuple):
    mask: torch.Tensor              # [B, F, T] full-spec mask (zero-padded)
    magnitude: torch.Tensor         # [B, 513, 249] |STFT|
    phase: torch.Tensor             # [B, 513, 249]
    relevant_wav: torch.Tensor      # [B, 80000] listenable explanation
    irrelevant_wav: torch.Tensor    # [B, 80000] complement
    probs_clean: torch.Tensor       # [B, 1]
    probs_relevant: torch.Tensor    # [B, 1]
    probs_irrelevant: torch.Tensor  # [B, 1]


class ADDvisorPipeline:
    """Owns the embedder, the UNet, the LogReg head, the feature decoder and
    the HiFi-GAN generator on one device.

    `device` defaults to "cuda" and raises when CUDA is missing; pass
    device="cpu" to run the kernels' plain versions on the CPU.

    Float32 products and convolutions run in full f32: TF32 is switched off
    for both cuBLAS and cuDNN (process-wide torch settings), because the UNet
    mask is what users hear and TF32 keeps about three decimal digits. The
    embedder's bf16 compute dtype is unaffected.
    """

    def __init__(self, cfg: PipelineConfig = PipelineConfig(), device="cuda", seed: int = 0):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.encoder = Wav2Vec2Encoder(cfg.embedder, gen, self.device).eval()
        self.encoder.requires_grad_(False)
        self.unet = init_unet_(UNetMaskDecoder(cfg.unet).to(self.device), gen).eval()
        self.logreg = logreg_init(cfg.embedder.hidden_size, gen, self.device)
        self.feat_decoder = FeatureMaskDecoder(cfg.feat_decoder, gen, self.device).eval()
        self.quant_scales: dict | None = None
        # an embedder forward in place of the encoder's own: (encoder,
        # normalised wav [B, L]) -> features [B, T, H]; the parallel layer's
        # pipelined encoder (`parallel/inference.py`)
        self.features_fn = None
        self._gen, self._hifigan = gen, None

    @property
    def hifigan(self) -> HiFiGANGenerator:
        """The vocoder, drawn from the pipeline's generator at its first use
        (a pipeline that never vocodes builds none); `convert.load_hifigan`
        or `load_state_dict(params_from_torch_state_dict(...))` set it."""
        if self._hifigan is None:
            with torch.inference_mode(False):  # normal tensors, even from `vocode`
                model = HiFiGANGenerator(self.cfg.hifigan).to(self.device)
                self._hifigan = init_hifigan_(model, self._gen).eval().requires_grad_(False)
        return self._hifigan

    def _as_input(self, wav) -> torch.Tensor:
        return torch.as_tensor(wav, dtype=torch.float32, device=self.device).contiguous()

    def embed(self, wav: torch.Tensor, encoder: Wav2Vec2Encoder | None = None) -> torch.Tensor:
        """wav [B, L] on the device -> features [B, T, H] f32 (normalise,
        then embed), carrying a gradient to wav when it asks for one."""
        encoder = self.encoder if encoder is None else encoder
        if self.features_fn is not None:
            return self.features_fn(encoder, zero_mean_unit_var_norm(wav))
        static = self.cfg.embedder.quant == "int8-static"
        return encoder(zero_mean_unit_var_norm(wav),
                       act_scales=self.quant_scales if static else None)

    @torch.inference_mode()
    def calibrate_quant(self, wavs, batch_size: int = 16, stat: str = "p999") -> dict:
        """Calibrate the static per-channel activation scales of the
        embedder's int8 sites on representative clips, keep them as
        `quant_scales` and return them ({site: [n_layers, C_site]}). Full
        batches only, as in the JAX package: the element-wise maximum of the
        batches' statistics, then `stat` / 127 with `stat` "max" (nothing in
        the calibration set saturates) or "p999" (the 99.9th percentile of
        each channel over the tokens: token-level outliers saturate, ordinary
        tokens keep their resolution). Calibrate in the attention mode that
        serves: the `ctx` site is NH * 128 wide with `fused_attention` and H
        wide without."""
        if self.cfg.embedder.quant not in ("int8", "int8-static"):
            raise ValueError("calibrate_quant needs an int8 embedder config "
                             f"(got quant={self.cfg.embedder.quant!r})")
        idx = {"max": 0, "p999": 1}[stat]
        wavs = self._as_input(wavs)
        n = wavs.shape[0]
        bs = min(batch_size, n)
        absmax = None
        for i in range(0, n - bs + 1, bs):
            _, m = self.encoder(zero_mean_unit_var_norm(wavs[i:i + bs]), calibrate=True)
            absmax = m if absmax is None else {k: torch.maximum(absmax[k], m[k]) for k in m}
        self.quant_scales = {k: per_127(a[:, idx]) for k, a in absmax.items()}
        return self.quant_scales

    def stft_stage(self, wav: torch.Tensor):
        return stft_magnitude_phase(wav, self.cfg.stft)

    def istft_stage(self, real: torch.Tensor, imag: torch.Tensor) -> torch.Tensor:
        return istft(real, imag, self.cfg.stft, length=self.cfg.audio.num_samples)

    @torch.inference_mode()
    def features(self, wav) -> torch.Tensor:
        """wav [B, L] -> features [B, T, H] f32 (normalise, then embed)."""
        return self.embed(self._as_input(wav))

    @torch.inference_mode()
    def classify_features(self, feats: torch.Tensor):
        """feats [B, T, H] -> (logits, probs) [B, 1] via the time mean-pool."""
        return logreg_apply(self.logreg, feats.mean(dim=1))

    def classify(self, wav):
        return self.classify_features(self.features(wav))

    @torch.inference_mode()
    def spectrogram(self, wav):
        """wav [B, L] -> (real, imag, magnitude, phase), each [B, 513, 249]."""
        return self.stft_stage(self._as_input(wav))

    @torch.inference_mode()
    def istft(self, real: torch.Tensor, imag: torch.Tensor) -> torch.Tensor:
        return self.istft_stage(real, imag)

    @torch.inference_mode()
    def predict_mask(self, magnitude: torch.Tensor) -> torch.Tensor:
        """Cropped magnitude -> UNet -> full-spec mask, zero on the cropped
        top bin and last frame."""
        uc = self.cfg.unet
        mask = self.unet(crop_spec(magnitude, uc.freq_bins, uc.frames))
        return pad_mask_to_spec(mask, magnitude.shape[-2], magnitude.shape[-1])

    @torch.inference_mode()
    def predict_mask_from_features(self, feats: torch.Tensor,
                                   magnitude: torch.Tensor) -> torch.Tensor:
        """Features [B, T, H] -> feature decoder -> full-spec mask, zero on
        the bins above `freq_bins`. T must be the spectrogram's frame count
        or less (`pad_mask_to_spec` raises otherwise)."""
        mask = self.feat_decoder(feats)
        return pad_mask_to_spec(mask, magnitude.shape[-2], magnitude.shape[-1])

    @torch.inference_mode()
    def explain(self, wav, decoder: str = "unet",
                masking: MaskingConvention | None = None) -> ExplainOutput:
        """The explanation path. With the UNet the mask depends only on the
        magnitude, so the clean clip and both masked re-syntheses share one
        3B-batch embedder pass. With the feature decoder the clean clip is
        embedded once at batch B, its features serving the decoder and the
        clean probability, and the masked clips share one 2B-batch pass."""
        if decoder not in ("unet", "features"):
            raise ValueError(f"unknown decoder {decoder!r}")
        masking = self.cfg.masking if masking is None else masking
        wav = self._as_input(wav)
        _, _, mag, phase = self.spectrogram(wav)
        if decoder == "unet":
            feats = None
            mask = self.predict_mask(mag)
        else:
            feats = self.features(wav)
            mask = self.predict_mask_from_features(feats, mag)
        rel_mag, irr_mag = apply_mask(mask, mag, masking)
        rel_wav = self.istft(*remask_complex(rel_mag, phase))
        irr_wav = self.istft(*remask_complex(irr_mag, phase))
        b = wav.shape[0]
        if feats is None:
            _, probs = self.classify(torch.cat([wav, rel_wav, irr_wav], dim=0))
        else:
            _, probs_both = self.classify(torch.cat([rel_wav, irr_wav], dim=0))
            probs = torch.cat([self.classify_features(feats)[1], probs_both])
        return ExplainOutput(
            mask=mask, magnitude=mag, phase=phase,
            relevant_wav=rel_wav, irrelevant_wav=irr_wav,
            probs_clean=probs[:b], probs_relevant=probs[b : 2 * b],
            probs_irrelevant=probs[2 * b :],
        )

    @torch.inference_mode()
    def vocode(self, wav) -> torch.Tensor:
        """Listenable synthesis: wav [B, L] -> log-mel -> HiFi-GAN -> wav
        [B, 256 (1 + L // 256)] f32."""
        return self.hifigan(mel_spectrogram(self._as_input(wav), self.cfg.mel))

    @torch.inference_mode()
    def explain_vocoded(self, wav, decoder: str = "unet",
                        masking: MaskingConvention | None = None
                        ) -> tuple[ExplainOutput, torch.Tensor]:
        """The full listenable path: `explain`, then the relevant waveform
        through `vocode` -> (ExplainOutput, vocoded relevant [B, L'])."""
        out = self.explain(wav, decoder, masking)
        return out, self.vocode(out.relevant_wav)
