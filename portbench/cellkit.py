"""What every explain cell shares: the port's pipeline configuration from
a configuration file, the seed's calibrated weights, the seed's clips, the
host copy of an explain's outputs and their comparison with the plain
reference."""

from __future__ import annotations

import torch

from portbench import check, clips, weights
from portbench.reference import explain as ref_explain


def pipeline_config(cfg: dict):
    from xai_audio_deepfakes_tpu_torch import config as C

    emb = dict(cfg["embedder"])
    for key in ("conv_dim", "conv_kernel", "conv_stride"):
        emb[key] = tuple(emb[key])
    extra = {}
    if "loss" in cfg:
        extra["loss"] = C.LossConfig(**dict(cfg["loss"], w_init=tuple(cfg["loss"]["w_init"]),
                                            masking=C.MaskingConvention(cfg["loss"]["masking"])))
    if "train" in cfg:
        extra["train"] = C.TrainConfig(**cfg["train"])
    return C.PipelineConfig(
        audio=C.AudioConfig(**cfg["audio"]),
        stft=C.STFTConfig(**cfg["stft"]),
        embedder=C.EmbedderConfig(**emb),
        unet=C.UNetConfig(**cfg["unet"]),
        masking=C.MaskingConvention(cfg["masking"]),
        **extra,
    )


def make_pool(cfg: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """The traffic's pool of distinct batches, [pool_batches, batch, samples]."""
    b, n_pool = traffic["batch"], traffic["pool_batches"]
    n = int(cfg["audio"]["clip_seconds"] * cfg["audio"]["sample_rate"])
    gen = torch.Generator(device=device).manual_seed(seed)
    return clips.speechlike(gen, n_pool * b, n, cfg["audio"]["sample_rate"], traffic["clips"],
                            device).view(n_pool, b, n)


def prepared_weights(cfg_file: dict, traffic: dict, seed: int, device) -> dict:
    """The seed's weights, calibrated, on `device`."""
    cfg = cfg_file["pipeline"]
    w = weights.draw(cfg, cfg_file["weights"], seed, device)
    weights.calibrate(w, cfg, cfg_file["weights"], traffic, seed, device)
    return w


def reference_numbers(w: dict, pool: torch.Tensor, kept: list, cfg: dict) -> dict:
    """The worst of each number over the pool's batches, the program's kept
    outputs against the plain reference's."""
    numbers: dict = {}
    with torch.no_grad(), ref_explain.precise():
        for slot in range(pool.shape[0]):
            ref = ref_explain.explain(w, pool[slot], cfg)
            numbers = check.merge(numbers, check.explain_numbers(kept[slot], ref))
            del ref
    return numbers


def host_copy(out) -> dict:
    return {k: v.detach().float().cpu().numpy() for k, v in out._asdict().items()}
