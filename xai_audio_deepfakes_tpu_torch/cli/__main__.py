"""Command-line entry points of the port (the JAX package's `cli`, flag for
flag, over the port's modules):

  python -m xai_audio_deepfakes_tpu_torch.cli explain  --wav a.wav b.wav --out dir
  python -m xai_audio_deepfakes_tpu_torch.cli train    --metadata m.txt --root d
  python -m xai_audio_deepfakes_tpu_torch.cli eval     --metadata m.txt --root d
  python -m xai_audio_deepfakes_tpu_torch.cli attrib   --metadata m.txt --method ig
  python -m xai_audio_deepfakes_tpu_torch.cli datagen  --metadata m.txt ...
  python -m xai_audio_deepfakes_tpu_torch.cli train-detector --features X.npz
  python -m xai_audio_deepfakes_tpu_torch.cli serve    --artifacts dir
  python -m xai_audio_deepfakes_tpu_torch.cli serve-api --port 8080
  python -m xai_audio_deepfakes_tpu_torch.cli export   --out art; serve-api --exported art

The differences from the JAX CLI, and only these: the global `--platform`
is `--device {cuda,cpu}` (default `$ADDVISOR_DEVICE`, else cuda; without a
card, cuda raises, and nothing falls back to the CPU), and `export
--platforms` names devices (`cuda,cpu`: one graph traced on each, the
`--device` pipeline's own the default; `serve-api --exported DIR --device
cpu` serves the CPU graph); the mesh flags of `train`, `eval` and
`closed-loop` lay a (data, stage, model) mesh over the processes of a
`torchrun` launch (NCCL on the card), whose product must be the world
size, and rank 0 alone prints, the other ranks writing their files under
`<out>/rank<r>`:

  torchrun --nproc-per-node 4 -m xai_audio_deepfakes_tpu_torch.cli eval \
      --metadata m.txt --root d --model-parallel 2 --batch-size 8

and without matplotlib the PNGs are skipped, named once on stderr, and
everything else is written.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _build_pipeline(args):
    import torch

    from xai_audio_deepfakes_tpu_torch.config import (
        EmbedderConfig,
        FeatDecoderConfig,
        PipelineConfig,
        STFTConfig,
        TrainConfig,
        UNetConfig,
    )
    from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline

    cfg = PipelineConfig(
        stft=STFTConfig(use_pallas=getattr(args, "stft_pallas", False)),
        embedder=EmbedderConfig(
            dtype=args.dtype,
            scan_layers=getattr(args, "scan_layers", False),
            remat=getattr(args, "remat", False),
            remat_policy=getattr(args, "remat_policy", "full"),
            quant=getattr(args, "quant", "none"),
            gelu=getattr(args, "gelu", "exact"),
            fused_ln_gelu=getattr(args, "fused_ln_gelu", False),
        ),
        unet=UNetConfig(quant=getattr(args, "unet_quant", "none")),
        feat_decoder=FeatDecoderConfig(
            hidden=getattr(args, "feat_hidden", 512),
            temporal_blocks=getattr(args, "feat_temporal_blocks", 2),
            attn_layers=getattr(args, "feat_attn_layers", 0),
        ),
        train=TrainConfig(
            target_quant=getattr(args, "target_quant", "none"),
            target_gelu=getattr(args, "target_gelu", "exact"),
            checkpoint_every=getattr(args, "checkpoint_every", 1),
            freeze_l1_weight=getattr(args, "freeze_l1_w", False),
        ),
    )
    pipe = ADDvisorPipeline(cfg, device=args.device, seed=args.seed)
    if args.embedder_dir:
        from xai_audio_deepfakes_tpu_torch.convert import load_encoder
        from xai_audio_deepfakes_tpu_torch.models.wav2vec2 import params_from_hf_dir

        load_encoder(pipe.encoder, params_from_hf_dir(args.embedder_dir, cfg.embedder)["params"])
    if args.logreg_joblib:
        from xai_audio_deepfakes_tpu_torch.models.logreg import logreg_params_from_any

        pipe.logreg = logreg_params_from_any(args.logreg_joblib, device=pipe.device)
    if args.checkpoint:
        from xai_audio_deepfakes_tpu_torch.train.train_addvisor import (
            restore_decoder_for_inference,
        )

        # eval/explain --decoder picks which decoder the checkpoint holds;
        # subcommands without that flag restore the UNet (the reference
        # trainer's decoder)
        restore_decoder_for_inference(args.checkpoint, pipe, getattr(args, "decoder", "unet"))
    if getattr(args, "unet_pth", ""):
        from xai_audio_deepfakes_tpu_torch.models.unet import load_reference_state_dict

        sd = torch.load(args.unet_pth, map_location=pipe.device, weights_only=True)
        load_reference_state_dict(pipe.unet, sd)
    if cfg.embedder.quant == "int8-static":
        # calibrate AFTER every weight import (the scales depend on the
        # final weights): --calib-wavs corpus if given, else a
        # deterministic synthetic speech batch
        import glob as _glob

        from xai_audio_deepfakes_tpu_torch.data.synthetic import speechlike_clips

        calib_dir = getattr(args, "calib_wavs", "")
        if calib_dir:
            from xai_audio_deepfakes_tpu_torch.data.io import load_audio

            paths = sorted(_glob.glob(os.path.join(calib_dir, "*.wav")))[:64]
            if not paths:
                raise SystemExit(f"--calib-wavs {calib_dir}: no .wav files")
            wavs = np.stack([load_audio(p)[0] for p in paths])
        else:
            wavs = speechlike_clips(
                np.random.default_rng(args.seed), 16,
                cfg.audio.num_samples, cfg.stft.sample_rate,
            )
        pipe.calibrate_quant(wavs)
    return pipe


def _load_hifigan(args, pipe) -> None:
    """The pipeline's HiFi-GAN generator (drawn from its seed at first use),
    or a torch / SpeechBrain generator checkpoint (--hifigan-ckpt)."""
    gen = pipe.hifigan
    if getattr(args, "hifigan_ckpt", ""):
        import torch

        from xai_audio_deepfakes_tpu_torch.models.hifigan import params_from_torch_state_dict

        sd = torch.load(args.hifigan_ckpt, map_location="cpu", weights_only=True)
        gen.load_state_dict(params_from_torch_state_dict(sd, pipe.cfg.hifigan))


class _Pngs:
    """Runs the PNG writers of `train/artifacts.py`. Without matplotlib
    (the card's machine has none) each PNG is skipped and recorded, and
    `report` names them once on stderr."""

    def __init__(self):
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            self.available = False
        else:
            self.available = True
        self.skipped: list[str] = []

    def save(self, writer, data, path: str, **kw) -> bool:
        """writer(data, path, **kw) if matplotlib is there; whether it ran."""
        if not self.available:
            self.skipped.append(os.path.basename(path))
            return False
        writer(data, path, **kw)
        return True

    def report(self) -> None:
        if self.skipped:
            print(f"warning: matplotlib is not installed; skipped {len(self.skipped)} PNG(s): "
                  + ", ".join(self.skipped), file=sys.stderr)


def _common(p: argparse.ArgumentParser):
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument(
        "--scan-layers", action="store_true",
        help="the scanned layer layout (one stacked parameter tree; identical "
             "numerics)",
    )
    p.add_argument(
        "--remat", action="store_true",
        help="recompute the embedder's layers in the backward pass "
             "(activation checkpointing) to save training memory",
    )
    p.add_argument(
        "--remat-policy", default="full", choices=["full", "dots"],
        help="with --remat: 'full' recomputes whole layers; 'dots' keeps the "
             "products' outputs and recomputes the rest",
    )
    p.add_argument(
        "--quant", default="none", choices=["none", "int8", "int8-static"],
        help="int8: the embedder's transformer products in int8 with dynamic "
             "per-token scales (serving only). int8-static: calibrated "
             "per-channel activation scales instead, calibrated at startup on "
             "--calib-wavs or a synthetic speech batch",
    )
    p.add_argument(
        "--calib-wavs", default="",
        help="--quant int8-static: directory of wavs to calibrate the "
             "static activation scales on (first 64 used); default: a "
             "deterministic synthetic speech batch",
    )
    p.add_argument(
        "--gelu", default="exact", choices=["exact", "tanh"],
        help="tanh: the GELU approximation",
    )
    p.add_argument(
        "--unet-quant", default="none", choices=["none", "int8"],
        help="int8: the UNet mask decoder's convolutions in int8 (serving "
             "only; unlike --quant this perturbs the mask itself)",
    )
    p.add_argument(
        "--stft-pallas", action="store_true",
        help="accepted for the JAX CLI's command lines: the STFT is kernel B "
             "either way",
    )
    p.add_argument(
        "--fused-ln-gelu", action="store_true",
        help="the conv frontend's LayerNorm+GELU as kernel D (one read and "
             "one write of the frontend's largest activations)",
    )
    p.add_argument("--embedder-dir", default="", help="local HF checkpoint dir")
    p.add_argument(
        "--logreg-joblib",
        default="",
        help="detector weights: sklearn joblib checkpoint, or the .npz "
        "written by train-detector",
    )
    p.add_argument("--checkpoint", default="",
                   help="a mask-decoder checkpoint (train's .pt, or a bare state dict)")
    p.add_argument(
        "--unet-pth", default="",
        help="reference-trained torch .pth UNet decoder "
             "(`addvisor.py` format, e.g. addvisor_epoch_89_loss_0.0177.pth; "
             "DDP 'module.' prefixes handled)",
    )
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--out", default="artifacts")
    # feature-decoder capacity knobs: must match between training
    # (closed-loop) and any command restoring a `--decoder features`
    # checkpoint, so they live on every pipeline builder
    p.add_argument(
        "--feat-hidden", type=int, default=512,
        help="feature decoder hidden width",
    )
    p.add_argument(
        "--feat-temporal-blocks", type=int, default=2,
        help="feature decoder: k5 residual conv blocks over frames",
    )
    p.add_argument(
        "--feat-attn-layers", type=int, default=0,
        help="feature decoder: self-attention+FFN blocks after the conv "
             "stack (0 = none)",
    )


def _mesh_flags(p: argparse.ArgumentParser):
    p.add_argument(
        "--data-parallel", type=int, default=0, metavar="DP",
        help="shard over a dp x pp x tp mesh of the torchrun processes: the "
             "batch over 'data' (0 = the world size / (pp x tp))",
    )
    p.add_argument(
        "--model-parallel", type=int, default=0, metavar="TP",
        help="tensor-parallel ways for the embedder within the mesh",
    )
    p.add_argument(
        "--pipeline-stages", type=int, default=0, metavar="PP",
        help="pipeline-parallel stages for the embedder layer stack "
             "(needs --scan-layers and output_layer %% PP == 0; composes "
             "with --model-parallel into a dp x pp x tp mesh)",
    )


def _mesh_from_args(args):
    """The (data, "stage", model) mesh the flags ask for over the world of
    processes (torchrun's, or a world of one), or None when no flag is set.
    A product other than the world size exits with code 2. On a rank other
    than 0, stdout goes to the null device and `args.out` to
    `<out>/rank<r>`, so that the ranks' files do not collide."""
    dp, tp, pp = (getattr(args, name, 0) for name in
                  ("data_parallel", "model_parallel", "pipeline_stages"))
    if not (dp or tp or pp):
        return None
    import torch.distributed as dist

    from xai_audio_deepfakes_tpu_torch.config import MeshConfig
    from xai_audio_deepfakes_tpu_torch.parallel.mesh import make_mesh

    try:
        mesh = make_mesh(MeshConfig(model_parallel=tp or 1), device=args.device,
                         pipeline_stages=pp or 1, data_parallel=dp)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2) from e
    rank = dist.get_rank()
    if rank and getattr(args, "out", None):
        args.out = os.path.join(args.out, f"rank{rank}")
        sys.stdout = open(os.devnull, "w")
    return mesh


def _mesh_batch(args, mesh) -> None:
    """Every batch shards over data x stages (the pipeline's default
    microbatches): the batch size must divide."""
    need = mesh.size(mesh.cfg.data_axis) * mesh.size("stage")
    if args.batch_size % need:
        raise SystemExit(f"--batch-size {args.batch_size} must be a multiple of "
                         f"data-parallel x stages = {need}")


def _batches(args, paths, pipe=None, drop_remainder=False):
    from xai_audio_deepfakes_tpu_torch.data.datasets import AudioBatcher

    kw = {}
    if pipe is not None:  # honor a non-default clip contract
        kw = dict(
            sample_rate=pipe.cfg.audio.sample_rate,
            clip_seconds=pipe.cfg.audio.clip_seconds,
        )
    return AudioBatcher(
        paths, batch_size=args.batch_size, root=args.root, shuffle=False,
        drop_remainder=drop_remainder, **kw,
    )


def _host(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def cmd_explain(args):
    from xai_audio_deepfakes_tpu_torch.config import MaskingConvention
    from xai_audio_deepfakes_tpu_torch.data.io import load_audio, write_wav
    from xai_audio_deepfakes_tpu_torch.serve.viewer import build_gallery
    from xai_audio_deepfakes_tpu_torch.train.artifacts import (
        save_mask_png,
        save_spectrogram_png,
    )

    # fail fast on bad inputs BEFORE the (expensive) model construction
    missing = [p for p in args.wav if not os.path.exists(p)]
    if missing:
        print(f"error: wav file(s) not found: {', '.join(missing)}", file=sys.stderr)
        return 2

    pipe = _build_pipeline(args)
    masking = MaskingConvention(args.masking)
    if args.synthesize:
        # wav -> mask -> masked iSTFT -> mel -> HiFi-GAN
        # (`pipeline/core.py::explain_vocoded`)
        _load_hifigan(args, pipe)
    os.makedirs(args.out, exist_ok=True)
    results = []
    items = []  # (stem, source, wav[80000])
    for path in args.wav:
        base = os.path.splitext(os.path.basename(path))[0]
        if args.chunk_long:
            from xai_audio_deepfakes_tpu_torch.data.io import load_audio_chunks

            chunks, starts = load_audio_chunks(
                path, clip_seconds=pipe.cfg.audio.clip_seconds
            )
            for i, (chunk, s) in enumerate(zip(chunks, starts)):
                suffix = f"_chunk{i}" if len(chunks) > 1 else ""
                items.append((f"{base}{suffix}", f"{path}@{int(s)}", chunk))
        else:
            items.append((base, path, load_audio(path)[0]))
    # fixed-shape batched calls: the tail is padded, so every call has one
    # shape; each output comes to the host once per batch
    bs = max(1, args.batch_size)
    outs, vocs = [], []
    for i in range(0, len(items), bs):
        group = items[i : i + bs]
        rows = np.zeros((bs, pipe.cfg.audio.num_samples), np.float32)
        for j, (_, _, w) in enumerate(group):
            rows[j] = w
        if args.synthesize:
            out, voc = pipe.explain_vocoded(rows, decoder=args.decoder, masking=masking)
            voc = _host(voc)
            vocs.extend(voc[j] for j in range(len(group)))
        else:
            out = pipe.explain(rows, decoder=args.decoder, masking=masking)
            vocs.extend([None] * len(group))
        host = {k: _host(v) for k, v in out._asdict().items()}
        outs.extend({k: v[j] for k, v in host.items()} for j in range(len(group)))
    pngs = _Pngs()
    for (stem, path, wav), out, voc in zip(items, outs, vocs):
        write_wav(os.path.join(args.out, f"{stem}_original.wav"), wav)
        write_wav(os.path.join(args.out, f"{stem}_explanation.wav"), out["relevant_wav"])
        if voc is not None:
            write_wav(
                os.path.join(args.out, f"{stem}_explanation_vocoded.wav"),
                voc,
            )
        mag, mask = out["magnitude"], out["mask"]
        record = {
            "source": path,
            "original_audio": f"{stem}_original.wav",
            "reconstructed_audio": f"{stem}_explanation.wav",
        }
        for key, name, writer, data, kw in (
            ("spectrogram_img", "spec", save_spectrogram_png, mag, {}),
            ("mask_img", "mask", save_mask_png, mask, {}),
            ("mask_compl_img", "mask_compl", save_mask_png, 1 - mask, {}),
            ("masked_spectrogram_img", "spec_masked", save_spectrogram_png,
             mask * np.log1p(mag), {"log1p": False}),
            ("compl_masked_spectrogram_img", "spec_masked_compl", save_spectrogram_png,
             (1 - mask) * np.log1p(mag), {"log1p": False}),
        ):
            if pngs.save(writer, data, os.path.join(args.out, f"{stem}_{name}.png"), **kw):
                record[key] = f"{stem}_{name}.png"
        record.update({
            "pred_original": float(out["probs_clean"][0]),
            "pred_reconstructed_mask": float(out["probs_relevant"][0]),
            "pred_reconstructed_1mask": float(out["probs_irrelevant"][0]),
        })
        results.append(record)
    index = build_gallery(results, args.out, polarity=pipe.cfg.polarity.value)
    pngs.report()
    print(json.dumps({"explained": len(results), "gallery": index}))


def cmd_train(args):
    from concurrent.futures import ThreadPoolExecutor

    from xai_audio_deepfakes_tpu_torch.data.datasets import extract_wavs
    from xai_audio_deepfakes_tpu_torch.train.artifacts import save_mask_png
    from xai_audio_deepfakes_tpu_torch.train.checkpoints import (
        latest_checkpoint,
        parse_checkpoint_name,
        restore_checkpoint,
        save_checkpoint,
        wait_for_saves,
    )
    from xai_audio_deepfakes_tpu_torch.train.train_addvisor import (
        init_train_state,
        train_addvisor,
    )
    from xai_audio_deepfakes_tpu_torch.utils.logging import JSONLLogger

    # fail fast on bad flags BEFORE the expensive model build
    mesh = _mesh_from_args(args)
    if mesh is not None:
        _mesh_batch(args, mesh)
    pipe = _build_pipeline(args)
    paths = extract_wavs(args.metadata)
    if args.limit:
        paths = paths[: args.limit]
    logger = JSONLLogger(os.path.join(args.out, "train_log.jsonl"))

    resume_state = None
    if args.resume:
        ckpt = latest_checkpoint(os.path.join(args.out, "ckpts"))
        if ckpt is not None:
            resume_state = restore_checkpoint(ckpt, init_train_state(pipe, args.train_decoder))
            logger({"resumed_from": ckpt, "epoch": parse_checkpoint_name(ckpt)[0]})

    # the mask's copy to the host and the matplotlib render run on one
    # worker thread, off the step loop
    pngs = _Pngs()
    artifact_pool = ThreadPoolExecutor(max_workers=1)
    artifact_futures = []

    def artifact_fn(epoch, mask, aux):
        l_in, l_out, l1 = aux["l_in"], aux["l_out"], aux["l1"]

        def _save():
            pngs.save(
                save_mask_png, _host(mask),
                os.path.join(args.out, f"{epoch + 1}_explanation.png"),
                title=(
                    f"L_in = {float(l_in):.6f}, L_out = {float(l_out):.6f}, "
                    f"L1 = {float(l1):.6f}"
                ),
            )

        artifact_futures.append(artifact_pool.submit(_save))

    def checkpoint_fn(epoch, state, loss):
        # the trainer hands a host snapshot; the write runs on the
        # checkpoint module's worker thread
        save_checkpoint(os.path.join(args.out, "ckpts"), epoch, loss, state, async_save=True)

    state = train_addvisor(
        pipe,
        # mesh batches keep the shardable shape: the tail is dropped
        batches=lambda: _batches(args, paths, pipe, drop_remainder=mesh is not None),
        num_epochs=args.epochs,
        mesh=mesh,
        log_fn=logger,
        artifact_fn=artifact_fn,
        checkpoint_fn=checkpoint_fn,
        initial_state=resume_state,
        decoder=args.train_decoder,
    )
    for f in artifact_futures:  # surface save errors
        f.result()
    artifact_pool.shutdown()
    wait_for_saves()
    pngs.report()
    print(json.dumps({"trained_steps": int(state.step)}))


def cmd_eval(args):
    from xai_audio_deepfakes_tpu_torch.config import MaskingConvention
    from xai_audio_deepfakes_tpu_torch.data.datasets import extract_wavs
    from xai_audio_deepfakes_tpu_torch.metrics.harness import run_explanation_metrics

    # fail fast on bad flags/paths BEFORE the expensive model build
    mesh = _mesh_from_args(args)
    paths = extract_wavs(args.metadata)
    if args.limit:
        paths = paths[: args.limit]
    pipe = _build_pipeline(args)
    drop = False
    if mesh is not None:
        _mesh_batch(args, mesh)
        if len(paths) % args.batch_size:
            drop = True  # a ragged tail cannot shard over 'data'
            print(f"note: dropping {len(paths) % args.batch_size} tail clip(s) so every "
                  f"batch shards dp={mesh.size(mesh.cfg.data_axis)}", file=sys.stderr)
    result = run_explanation_metrics(
        pipe, _batches(args, paths, pipe, drop_remainder=drop),
        decoder=args.decoder, masking=MaskingConvention(args.masking), mesh=mesh,
    )
    print(json.dumps(result))


def cmd_attrib(args):
    from xai_audio_deepfakes_tpu_torch.data.datasets import extract_wavs
    from xai_audio_deepfakes_tpu_torch.metrics.harness import run_attribution_metrics

    pipe = _build_pipeline(args)
    paths = extract_wavs(args.metadata)
    if args.limit:
        paths = paths[: args.limit]

    artifact_fn = None
    records: list[dict] = []
    pngs = _Pngs()
    if args.save_artifacts:
        # per-file artifacts (`captum_saliency.py:136-166`): listenable
        # relevant/irrelevant waveforms, original/relevant/irrelevant
        # spectrogram PNGs, and the waveform-mask line plot, fed into the
        # same gallery the explain path uses
        from xai_audio_deepfakes_tpu_torch.data.io import write_wav
        from xai_audio_deepfakes_tpu_torch.train.artifacts import (
            save_spectrogram_png,
            save_waveform_mask_png,
        )

        os.makedirs(args.out, exist_ok=True)
        counter = {"i": 0}
        limit = args.artifact_limit

        def spec_of(w):
            return _host(pipe.spectrogram(w[None])[2])[0]

        def artifact_fn(wav, mask, rel, irr, p_clean, p_rel, p_irr):
            for j in range(wav.shape[0]):
                i = counter["i"]
                counter["i"] += 1
                if i >= len(paths) or (limit and i >= limit):
                    return
                stem = os.path.splitext(os.path.basename(paths[i]))[0]
                stem = f"{stem}_{args.method}"
                write_wav(os.path.join(args.out, f"{stem}_original.wav"), wav[j])
                write_wav(os.path.join(args.out, f"{stem}_relevant.wav"), rel[j])
                write_wav(os.path.join(args.out, f"{stem}_irrelevant.wav"), irr[j])
                record = {
                    "source": paths[i],
                    "original_audio": f"{stem}_original.wav",
                    "reconstructed_audio": f"{stem}_relevant.wav",
                }
                for key, name, data, kw in (
                    ("spectrogram_img", "spec", wav[j], {}),
                    ("masked_spectrogram_img", "spec_relevant", rel[j],
                     {"title": "Relevant (wav x mask)"}),
                    ("compl_masked_spectrogram_img", "spec_irrelevant", irr[j],
                     {"title": "Irrelevant (wav x (1 - mask))"}),
                ):
                    path = os.path.join(args.out, f"{stem}_{name}.png")
                    if pngs.save(save_spectrogram_png, spec_of(data), path, **kw):
                        record[key] = f"{stem}_{name}.png"
                if pngs.save(save_waveform_mask_png, mask[j],
                             os.path.join(args.out, f"{stem}_wavmask.png"),
                             wav=wav[j], title=f"{args.method} attribution mask"):
                    record["mask_img"] = f"{stem}_wavmask.png"
                record.update({
                    "pred_original": float(p_clean[j, 0]),
                    "pred_reconstructed_mask": float(p_rel[j, 0]),
                    "pred_reconstructed_1mask": float(p_irr[j, 0]),
                })
                records.append(record)

    result = run_attribution_metrics(
        pipe, _batches(args, paths, pipe), method=args.method,
        artifact_fn=artifact_fn,
    )
    if records:
        from xai_audio_deepfakes_tpu_torch.serve.viewer import build_gallery

        result["gallery"] = build_gallery(
            records, args.out, polarity=pipe.cfg.polarity.value
        )
        result["artifacts"] = len(records)
    pngs.report()
    print(json.dumps(result))


def cmd_datagen(args):
    """Band-splice dataset generation (`train_logReg_swapping.py:29-102`)."""
    from xai_audio_deepfakes_tpu_torch.data.bandswap import generate_band_swap_features
    from xai_audio_deepfakes_tpu_torch.data.datasets import extract_wavs
    from xai_audio_deepfakes_tpu_torch.data.io import load_audio
    from xai_audio_deepfakes_tpu_torch.utils.logging import JSONLLogger

    pipe = _build_pipeline(args)
    paths = extract_wavs(args.metadata)
    if args.limit:
        paths = paths[: args.limit]
    logger = JSONLLogger(None)

    def embed_fn(wavs):
        return pipe.features(wavs).mean(dim=1)

    def pairs():
        for p in paths:
            real = load_audio(os.path.join(args.root, p))[0]
            voc_path = os.path.join(args.vocoded_root, p + "_vocoded.wav")
            if not os.path.exists(voc_path):
                voc_path = os.path.join(args.vocoded_root, p)
            if not os.path.exists(voc_path):
                continue
            yield real, load_audio(voc_path)[0]

    x, y = generate_band_swap_features(pairs(), embed_fn, log_fn=logger, device=pipe.device)
    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, "band_swap_features.npz"), X=x, y=y)
    print(json.dumps({"X_shape": list(x.shape), "labels": int(y.sum())}))


def cmd_embed(args):
    """Batched SSL feature extraction over a corpus: wav folder/metadata ->
    mean-pooled embeddings npz + per-clip detector scores (the `collate_fn`
    capability, `train_addvisor.py:247-260`)."""
    from xai_audio_deepfakes_tpu_torch.data.datasets import extract_wavs

    pipe = _build_pipeline(args)
    paths = extract_wavs(args.metadata)
    if args.limit:
        paths = paths[: args.limit]
    pngs = _Pngs()
    feats_all, probs_all, names = [], [], []
    n = 0
    for wav in _batches(args, paths, pipe):
        feats = pipe.features(wav)
        _, probs = pipe.classify_features(feats)
        if n == 0 and getattr(args, "features_png", False):
            # feature-map visual dump (`train_addvisor.py:59-94` plot_features)
            from xai_audio_deepfakes_tpu_torch.train.artifacts import save_features_png

            os.makedirs(args.out, exist_ok=True)
            pngs.save(save_features_png, _host(feats[0]),
                      os.path.join(args.out, "features.png"),
                      title=os.path.basename(paths[0]))
        feats_all.append(_host(feats.mean(dim=1)))
        probs_all.append(_host(probs))
        names.extend(paths[n : n + wav.shape[0]])
        n += wav.shape[0]
    os.makedirs(args.out, exist_ok=True)
    np.savez(
        os.path.join(args.out, "embeddings.npz"),
        features=np.concatenate(feats_all),
        probs=np.concatenate(probs_all),
        paths=np.asarray(names),
    )
    pngs.report()
    print(json.dumps({"embedded": n, "dim": int(feats_all[0].shape[1])}))


def cmd_vocode_datagen(args):
    """Vocoded band-spliced dataset generation (`hifigan.py:91-230`)."""
    from xai_audio_deepfakes_tpu_torch.data.datasets import extract_wavs
    from xai_audio_deepfakes_tpu_torch.data.vocoded import (
        generate_vocoded_dataset,
        make_vocoder_fn,
    )
    from xai_audio_deepfakes_tpu_torch.utils.logging import JSONLLogger

    pipe = _build_pipeline(args)
    _load_hifigan(args, pipe)
    names = extract_wavs(args.metadata)
    if args.limit:
        names = names[: args.limit]
    n = generate_vocoded_dataset(
        names, args.root, args.out, make_vocoder_fn(pipe),
        log_fn=JSONLLogger(None), device=pipe.device,
    )
    print(json.dumps({"written": n}))


def cmd_train_detector(args):
    from xai_audio_deepfakes_tpu_torch.models.logreg import logreg_params_save
    from xai_audio_deepfakes_tpu_torch.train.train_logreg import train_detector

    z = np.load(args.features)
    params, metrics = train_detector(z["X"], z["y"], c=args.c, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    logreg_params_save(params, os.path.join(args.out, "logreg_vocoded_anyband.npz"))
    print(json.dumps(metrics))


def cmd_closed_loop(args):
    """Closed-loop explanation-quality protocol: band-swap corpus with a
    KNOWN artifact band -> train the detector -> train the mask decoder
    against it -> verify the mask localizes the band and flips the detector
    on the complement (`train/closed_loop.py`)."""
    from xai_audio_deepfakes_tpu_torch.config import (
        EmbedderConfig,
        FeatDecoderConfig,
        LossConfig,
        MaskingConvention,
        PipelineConfig,
        STFTConfig,
        TrainConfig,
        UNetConfig,
    )
    from xai_audio_deepfakes_tpu_torch.data.io import write_wav
    from xai_audio_deepfakes_tpu_torch.serve.viewer import build_gallery
    from xai_audio_deepfakes_tpu_torch.train.artifacts import (
        save_mask_png,
        save_spectrogram_png,
    )
    from xai_audio_deepfakes_tpu_torch.train.checkpoints import (
        save_checkpoint,
        wait_for_saves,
    )
    from xai_audio_deepfakes_tpu_torch.train.closed_loop import run_closed_loop
    from xai_audio_deepfakes_tpu_torch.utils.logging import JSONLLogger

    mesh = _mesh_from_args(args)
    cfg = PipelineConfig(
        stft=STFTConfig(use_pallas=args.stft_pallas),
        embedder=EmbedderConfig(
            dtype=args.dtype, scan_layers=args.scan_layers, remat=args.remat,
            remat_policy=args.remat_policy, gelu=args.gelu,
            fused_ln_gelu=args.fused_ln_gelu,
        ),
        unet=UNetConfig(quant=args.unet_quant),
        feat_decoder=FeatDecoderConfig(
            hidden=args.feat_hidden,
            temporal_blocks=args.feat_temporal_blocks,
            attn_layers=args.feat_attn_layers,
        ),
        train=TrainConfig(
            model_lr=args.model_lr,
            freeze_l1_weight=args.freeze_l1_w,
        ),
        loss=LossConfig(masking=MaskingConvention(args.loss_masking)),
    )
    os.makedirs(args.out, exist_ok=True)
    logger = JSONLLogger(os.path.join(args.out, "closed_loop_log.jsonl"))
    n_wavs = min(args.artifact_limit, 4)
    res = run_closed_loop(
        cfg, seed=args.seed, n_train=args.n_train, n_eval=args.n_eval,
        band=(args.band_lo, args.band_hi), epochs=args.epochs,
        batch_size=args.batch_size, noise_rms=args.noise_rms,
        log_fn=logger, keep_wavs=n_wavs, anyband=args.anyband,
        band_width=args.band_width, decoder=args.decoder,
        l1_scale=args.l1_scale, l1_warmup_epochs=args.l1_warmup_epochs,
        device=args.device, mesh=mesh,
    )
    eval_bands = res.get("eval_bands_hz")
    masks, mags = res.pop("final_masks"), res.pop("final_magnitude")
    rel = res.pop("final_relevant_wavs", None)
    irr = res.pop("final_irrelevant_wavs", None)
    manip = res.pop("eval_manipulated", None)
    probs = res.pop("final_probs", None)
    state = res.pop("state", None)
    # the trained decoder, restorable by `cli eval/explain --checkpoint`
    # (`train/train_addvisor.py::restore_decoder_for_inference`)
    if state is not None:
        log = res.get("train_log") or []
        final_loss = log[-1]["loss"] if log else 0.0
        save_checkpoint(
            os.path.join(args.out, "ckpts"), args.epochs, final_loss, state
        )

    def band_of(i: int) -> tuple[float, float]:
        return (eval_bands[i][0], eval_bands[i][1]) if eval_bands else (args.band_lo, args.band_hi)

    pngs = _Pngs()
    written: dict = {}
    sr = cfg.audio.sample_rate
    for i in range(min(args.artifact_limit, len(masks))):
        lo, hi = band_of(i)
        written[f"final_mask_{i}.png"] = pngs.save(
            save_mask_png, masks[i], os.path.join(args.out, f"final_mask_{i}.png"),
            title=f"learned mask, artifact band {lo:.0f}-{hi:.0f} Hz",
        )
        written[f"manipulated_spec_{i}.png"] = pngs.save(
            save_spectrogram_png, mags[i], os.path.join(args.out, f"manipulated_spec_{i}.png"),
            title="manipulated clip |STFT|",
        )
    # the listenable product claim (`captum_saliency.py:136-143` shape):
    # manipulated input + what the mask keeps + what it removes
    gallery_items = []
    if rel is not None:
        manip = np.asarray(manip.cpu() if hasattr(manip, "cpu") else manip)
        for i in range(len(rel)):
            write_wav(os.path.join(args.out, f"eval_{i}_manipulated.wav"), manip[i], sr)
            write_wav(os.path.join(args.out, f"eval_{i}_relevant.wav"), rel[i], sr)
            write_wav(os.path.join(args.out, f"eval_{i}_irrelevant.wav"), irr[i], sr)
            if probs is None or i >= len(probs):
                continue
            lo, hi = band_of(i)
            item = {
                "source": f"held-out eval clip {i} (artifact band {lo:.0f}-{hi:.0f} Hz)",
                "original_audio": f"eval_{i}_manipulated.wav",
                "reconstructed_audio": f"eval_{i}_relevant.wav",
                "pred_original": float(probs[i, 0]),
                "pred_reconstructed_mask": float(probs[i, 1]),
                "pred_reconstructed_1mask": float(probs[i, 2]),
            }
            for key, name in (("spectrogram_img", f"manipulated_spec_{i}.png"),
                              ("mask_img", f"final_mask_{i}.png")):
                if written.get(name):
                    item[key] = name
            gallery_items.append(item)
    if gallery_items:
        # the same listening-study gallery `cli explain`/`cli serve` use
        # (`serve/viewer.py`): `cli serve --artifacts <out>`
        build_gallery(gallery_items, args.out, polarity=cfg.polarity.value)
    with open(os.path.join(args.out, "closed_loop.json"), "w") as f:
        json.dump(res, f, indent=1, default=float)
    wait_for_saves()
    pngs.report()
    print(json.dumps(res, default=float))


def cmd_serve(args):
    from xai_audio_deepfakes_tpu_torch.serve.viewer import serve_gallery

    serve_gallery(args.artifacts, port=args.port)


def cmd_profile(args):
    """Per-stage timing breakdown (+ optional torch.profiler trace) of the
    explanation pipeline."""
    import contextlib

    import torch

    from xai_audio_deepfakes_tpu_torch.data.io import load_audio
    from xai_audio_deepfakes_tpu_torch.utils.profiling import StageTimer, trace

    pipe = _build_pipeline(args)
    if args.wav:
        wavs = np.stack([load_audio(p)[0] for p in args.wav])
        reps = max(1, args.batch_size // wavs.shape[0])
        wavs = np.tile(wavs, (reps, 1))[: args.batch_size]
    else:
        wavs = (
            np.random.default_rng(args.seed)
            .standard_normal((args.batch_size, pipe.cfg.audio.num_samples))
            .astype(np.float32)
            * 0.1
        )
    wav = torch.from_numpy(wavs).to(pipe.device)

    stages = {
        "stft": lambda: pipe.spectrogram(wav),
        "embed": lambda: pipe.features(wav),
        "mask_unet": lambda: pipe.predict_mask(pipe.spectrogram(wav)[2]),
        "explain_full": lambda: pipe.explain(wav, decoder=args.decoder),
    }
    timer = StageTimer()
    for fn in stages.values():  # first launches (and the kernel build) untimed
        StageTimer().timed("warmup", fn)()
    ctx = trace(args.trace_dir) if args.trace_dir else contextlib.nullcontext()
    with ctx:
        for _ in range(args.iters):
            for name, fn in stages.items():
                timer.timed(name, fn)()
    summary = timer.summary()
    summary["batch"] = args.batch_size
    summary["device"] = (torch.cuda.get_device_name(pipe.device)
                         if pipe.device.type == "cuda" else "cpu")
    if args.trace_dir:
        summary["trace_dir"] = args.trace_dir
    print(json.dumps(summary))


def cmd_export(args):
    """Trace the explain graph and write a self-contained serving artifact
    (graph + weights + meta), see `serve/export.py`."""
    from xai_audio_deepfakes_tpu_torch.serve.export import save_exported

    platforms = tuple(p for p in args.platforms.split(",") if p) or None
    pipe = _build_pipeline(args)
    out = save_exported(
        args.out,
        pipe,
        batch_size=args.batch_size,
        decoder=args.decoder,
        masking=args.masking,
        platforms=platforms,
    )
    sizes = {
        f: os.path.getsize(os.path.join(out, f)) for f in sorted(os.listdir(out))
    }
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    print(json.dumps({"artifact": out, "device": meta["device"], "platforms": meta["platforms"],
                      "batch_size": args.batch_size, "files": sizes}))
    return 0


def cmd_serve_api(args):
    from xai_audio_deepfakes_tpu_torch.serve.api import serve_api

    if args.exported:
        from xai_audio_deepfakes_tpu_torch.serve.export import load_exported

        art = load_exported(args.exported, device=args.device)
        serve_api(
            art,
            port=args.port,
            batch_size=art.batch_size,
            linger_ms=args.linger_ms,
            decoder=art.decoder,
            explain_fn=art,
        )
        return
    pipe = _build_pipeline(args)
    serve_api(
        pipe,
        port=args.port,
        batch_size=args.batch_size,
        linger_ms=args.linger_ms,
        decoder=args.decoder,
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="xai_audio_deepfakes_tpu_torch")
    parser.add_argument(
        "--device", default=os.environ.get("ADDVISOR_DEVICE", "cuda"),
        choices=["cuda", "cpu"],
        help="where the pipeline runs (default cuda, which raises without a "
             "card; cpu runs the kernels' plain versions). Also settable via "
             "ADDVISOR_DEVICE.",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("explain", help="wav -> mask -> listenable explanation")
    _common(p)
    p.add_argument("--wav", nargs="+", required=True)
    p.add_argument("--decoder", default="unet", choices=["unet", "features"])
    p.add_argument("--masking", default="log1p", choices=["linear", "log1p"])
    p.add_argument(
        "--chunk-long", action="store_true",
        help="explain every 5 s window of long files (default: first 5 s, "
             "the reference behavior)",
    )
    p.add_argument(
        "--synthesize", action="store_true",
        help="also re-synthesize the explanation through HiFi-GAN "
             "(mel -> generator) into {stem}_explanation_vocoded.wav",
    )
    p.add_argument("--hifigan-ckpt", default="", help="torch generator state dict")
    p.set_defaults(fn=cmd_explain)

    p = sub.add_parser("train", help="train the mask decoder")
    _common(p)
    p.add_argument("--metadata", required=True)
    p.add_argument("--root", default="")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument(
        "--train-decoder", default="unet", choices=["unet", "features"],
        dest="train_decoder",
        help="which mask decoder to train: the UNet (the reference trainer's "
             "decoder, train_addvisor.py:363) or the feature-input decoder "
             "(LMAC_metrics.py:133 consumer; requires the frame-alignment "
             "contract)",
    )
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --out/ckpts")
    p.add_argument(
        "--checkpoint-every", type=int, default=1, metavar="N",
        help="checkpoint every N epochs (0 = never)",
    )
    p.add_argument(
        "--target-quant", default="none", choices=["none", "int8"],
        help="int8 products for the gradient-free target embed only (the "
             "clean forward that produces y_hat); the differentiated graph "
             "stays exact",
    )
    p.add_argument(
        "--target-gelu", default="exact", choices=["exact", "tanh"],
        help="tanh GELU for the target embed only (see --target-quant)",
    )
    _mesh_flags(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="faithfulness metric sweep")
    _common(p)
    p.add_argument("--metadata", required=True)
    p.add_argument("--root", default="")
    p.add_argument("--decoder", default="unet", choices=["unet", "features"])
    p.add_argument("--masking", default="log1p", choices=["linear", "log1p"])
    p.add_argument("--limit", type=int, default=0)
    _mesh_flags(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("attrib", help="gradient-attribution metric sweep")
    _common(p)
    p.add_argument("--metadata", required=True)
    p.add_argument("--root", default="")
    p.add_argument(
        "--method", default="input_x_gradient",
        choices=["saliency", "input_x_gradient", "integrated_gradients",
                 "smoothgrad", "gradient_shap"],
    )
    p.add_argument("--limit", type=int, default=0)
    p.add_argument(
        "--save-artifacts", action="store_true",
        help="per-file artifacts into --out: relevant/irrelevant wavs, "
             "original/relevant/irrelevant spectrogram PNGs, waveform-mask "
             "plot, and a gallery index (`captum_saliency.py:136-166`)",
    )
    p.add_argument(
        "--artifact-limit", type=int, default=32,
        help="cap on clips that get artifacts (0 = all; metrics still "
             "cover every clip)",
    )
    p.set_defaults(fn=cmd_attrib)

    p = sub.add_parser("datagen", help="band-splice detector training data")
    _common(p)
    p.add_argument("--metadata", required=True)
    p.add_argument("--root", default="")
    p.add_argument("--vocoded-root", required=True)
    p.add_argument("--limit", type=int, default=0)
    p.set_defaults(fn=cmd_datagen)

    p = sub.add_parser("embed", help="batched SSL embeddings + detector scores")
    _common(p)
    p.add_argument("--metadata", required=True)
    p.add_argument("--root", default="")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument(
        "--features-png", action="store_true",
        help="dump the first clip's [T, H] feature map as features.png "
             "(the reference's plot_features, train_addvisor.py:59-94)",
    )
    p.set_defaults(fn=cmd_embed)

    p = sub.add_parser("vocode-datagen", help="HiFi-GAN vocoded band-splice wavs")
    _common(p)
    p.add_argument("--metadata", required=True)
    p.add_argument("--root", default="")
    p.add_argument("--hifigan-ckpt", default="", help="torch generator state dict")
    p.add_argument("--limit", type=int, default=0)
    p.set_defaults(fn=cmd_vocode_datagen)

    p = sub.add_parser("train-detector", help="fit the LogReg detector head")
    p.add_argument("--features", required=True, help="npz with X, y")
    p.add_argument("--c", type=float, default=1e6)
    p.add_argument("--out", default="artifacts")
    p.set_defaults(fn=cmd_train_detector)

    p = sub.add_parser(
        "closed-loop",
        help="explanation-quality capstone: known-band corpus -> detector "
             "-> mask decoder -> localization + flip verification",
    )
    _common(p)
    p.add_argument("--band-lo", type=float, default=2000.0)
    p.add_argument("--band-hi", type=float, default=3000.0)
    p.add_argument(
        "--anyband", action="store_true",
        help="draw the artifact band PER CLIP from the 1 kHz grid (the "
             "reference's anyband protocol, train_logReg_swapping.py:70-92) "
             "and score per-clip localization + input-dependence; "
             "--band-lo/--band-hi are ignored",
    )
    p.add_argument(
        "--band-width", type=float, default=1000.0,
        help="anyband grid band width in Hz (grid spans [0, 8000))",
    )
    p.add_argument(
        "--decoder", default="unet", choices=["unet", "features"],
        help="which mask decoder the loop trains: the UNet or the "
             "feature-input decoder (LMAC_metrics.py:133 consumer)",
    )
    p.add_argument(
        "--loss-masking", default="linear", choices=["linear", "log1p"],
        help="masking convention for BOTH the training loss and the eval "
             "(linear = training convention loss_function.py:38-45; log1p = "
             "the eval/serving convention LMAC_metrics.py:136-153)",
    )
    p.add_argument("--n-train", type=int, default=64)
    p.add_argument("--n-eval", type=int, default=16)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--noise-rms", type=float, default=1.0)
    p.add_argument(
        "--model-lr", type=float, default=3e-4,
        help="decoder Adam lr (the loop's short schedule wants a hotter lr "
             "than the reference's 3e-5 1000-epoch default)",
    )
    p.add_argument(
        "--l1-scale", type=float, default=None,
        help="multiplier on the L1 sparsity term (default: the exact "
             "reference formula, = 1.0)",
    )
    p.add_argument(
        "--freeze-l1-w", action="store_true",
        help="decouple the learnable loss weights from the L1 term: w[2] "
             "takes no gradient step and is excluded from the post-step "
             "renorm (l_in/l_out renormalize among themselves to sum 2); "
             "default off = the reference's dynamics "
             "(train_addvisor.py:379-380)",
    )
    p.add_argument(
        "--l1-warmup-epochs", type=int, default=0,
        help="ramp --l1-scale linearly from 1.0 (reference formula) over "
             "this many epochs",
    )
    p.add_argument("--artifact-limit", type=int, default=8)
    _mesh_flags(p)
    p.set_defaults(fn=cmd_closed_loop)

    p = sub.add_parser("serve", help="host the listening-study gallery")
    p.add_argument("--artifacts", required=True)
    p.add_argument("--port", type=int, default=8000)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("profile", help="per-stage timings + torch.profiler trace")
    _common(p)
    p.add_argument("--wav", nargs="*", default=[])
    p.add_argument("--decoder", default="unet", choices=["unet", "features"])
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--trace-dir", default="",
                   help="write a torch.profiler Chrome trace here")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("serve-api", help="live explain API (micro-batched serving)")
    _common(p)
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--decoder", default="unet", choices=["unet", "features"])
    p.add_argument("--linger-ms", type=float, default=5.0)
    p.add_argument(
        "--exported", default="",
        help="serve from an artifact dir written by `export` (no model code; "
             "batch size/decoder come from its meta.json)",
    )
    p.set_defaults(fn=cmd_serve_api)

    p = sub.add_parser("export", help="trace + save the explain graph (serving artifact)")
    _common(p)
    p.add_argument("--decoder", default="unet", choices=["unet", "features"])
    p.add_argument("--masking", default="log1p", choices=["linear", "log1p"])
    p.add_argument(
        "--platforms", default="",
        help="comma-separated devices to trace a graph for (cuda, cpu; default: --device's); "
             "cuda needs a card",
    )
    p.set_defaults(fn=cmd_export)
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    # int8 quantization is serving-only: rounding has zero gradient, so a
    # subcommand that differentiates through the embedder (trainer loss,
    # attribution maps) would differentiate through a constant
    if getattr(args, "quant", "none") != "none" and args.fn in (
        cmd_train,
        cmd_attrib,
    ):
        parser.error(
            "--quant int8 is serving-only: quantized matmuls have zero "
            "gradient, so train/attrib would silently differentiate through "
            "a constant. Use --quant none for gradient-dependent commands."
        )
    # --unet-quant on the trainer would be silently ignored (the module takes
    # the float path when training); on subcommands whose graph never runs
    # the UNet it has no effect either: warn there
    if getattr(args, "unet_quant", "none") != "none":
        if args.fn is cmd_train:
            parser.error(
                "--unet-quant int8 is serving-only (the training graph needs "
                "gradients through the UNet; quantized convs have none)."
            )
        if args.fn in (
            cmd_attrib,
            cmd_embed,
            cmd_datagen,
            cmd_vocode_datagen,
        ):
            print(
                "warning: --unet-quant has no effect here — this subcommand's "
                "graph does not include the UNet mask decoder",
                file=sys.stderr,
            )
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
