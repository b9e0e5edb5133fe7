"""Serving artifacts (port of the JAX package's `serve/export.py`): the
explain graph on disk, run later by a process that imports no model code.

`torch.export` traces `pipe.explain` once at a fixed batch size: the STFT,
the mask decoder, the masked iSTFTs, the one 3B-batch embedder pass and the
detector head, with every hand-written kernel kept as its registered op
(`addv::attention`, `addv::stft`, `addv::istft`, ...; `ops/_cuda.py`). A
loaded artifact calls those ops, so it launches the same kernels and counts
the same launches; the loader imports the op registrations and nothing of
`models/` or `pipeline/`.

Layout of an artifact directory:

    explain.pt2   the graph (`torch.export.save`), without weights, for
                  the default device; explain.<device>.pt2 for each other
    params.npz    weights, flattened with '/' (bf16 ones stored as f32,
                  which is exact; meta.json keeps each one's dtype)
    meta.json     batch size, clip samples, sample rate, decoder, masking,
                  the default device and every device exported for
                  (`platforms`), torch's version

The weights stay OUTSIDE the graph, as call arguments (the exported
program's `state_dict` is empty), as in the JAX package: a retrained mask
decoder drops in by replacing params.npz alone, or in memory through
`ExportedExplain.with_params`. The graph's outputs are a plain tuple, which
`ExportedExplain` names again (`OUTPUT_FIELDS`), so the loader needs no
output type registered.

A graph holds its device's own choices (one traced on the CPU runs the
kernels' plain versions, which are the `addv::*` ops' CPU implementations),
so an artifact holds one graph per device it was exported for, as the JAX
package's holds one lowering per platform (`platforms`): `explain.pt2` for
the default device and `explain.<device>.pt2` for each other, every graph
taking the same params.npz. `save_exported(platforms=("cuda", "cpu"))`
traces each on a pipeline of that device holding the same weights;
`platforms=None` exports the pipeline's own device alone. `meta.json` lists
`platforms` and names the default `device`; `load_exported(dir, device)`
loads the graph of `device` (default: that one) and raises for a device the
artifact lacks. Exporting for `cuda` needs a card: nothing falls back.
"""

from __future__ import annotations

import collections
import json
import os
import types

import numpy as np
import torch

from xai_audio_deepfakes_tpu_torch.config import AudioConfig, MaskingConvention
from xai_audio_deepfakes_tpu_torch.utils.profiling import paused

_GRAPH_FILE = "explain.pt2"
_PARAMS_FILE = "params.npz"
_META_FILE = "meta.json"

# the fields of `pipeline.core.ExplainOutput`, in its order
OUTPUT_FIELDS = ("mask", "magnitude", "phase", "relevant_wav", "irrelevant_wav",
                 "probs_clean", "probs_relevant", "probs_irrelevant")
ExplainOutput = collections.namedtuple("ExplainOutput", OUTPUT_FIELDS)

_DECODER_MODULES = {"unet": ("encoder", "unet"), "features": ("encoder", "feat_decoder")}


# ----------------------------------------------------------------------
# param tree <-> flat npz
# ----------------------------------------------------------------------


def flatten_params(params: dict, prefix: str = "") -> dict:
    """Nested dict of tensors or arrays -> {'a/b/c': leaf}. Keys must not
    contain '/'."""
    out: dict = {}
    for k, v in params.items():
        if "/" in str(k):
            raise ValueError(f"param key {k!r} contains '/'")
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_params(v, key + "/"))
        else:
            out[key] = v
    return out


def unflatten_params(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def explain_params(pipe, decoder: str = "unet") -> dict:
    """The weights `pipe.explain(decoder=...)` reads, as a nested dict of the
    pipeline's own tensors: {"encoder": ..., "unet" | "feat_decoder": ...}
    (each module's state dict split at its dots), "logreg" and, after
    `calibrate_quant`, "quant_scales"."""
    if decoder not in _DECODER_MODULES:
        raise ValueError(f"unknown decoder {decoder!r}")
    tree: dict = {}
    for name in _DECODER_MODULES[decoder]:
        sd = getattr(pipe, name).state_dict(keep_vars=True)
        tree[name] = unflatten_params({k.replace(".", "/"): v for k, v in sd.items()})
    tree["logreg"] = dict(pipe.logreg)
    if pipe.quant_scales is not None:
        tree["quant_scales"] = dict(pipe.quant_scales)
    return tree


def _to_numpy(t) -> np.ndarray:
    t = torch.as_tensor(t).detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _place(params: dict, dtypes: dict, device: torch.device) -> dict:
    """Weights (nested, or flat with '/' keys) as the graph takes them: flat,
    each key's dtype, on `device` (copied there once)."""
    nested = any(isinstance(v, dict) for v in params.values())
    flat = flatten_params(params) if nested else params
    if set(flat) != set(dtypes):
        missing, extra = sorted(set(dtypes) - set(flat)), sorted(set(flat) - set(dtypes))
        raise ValueError(f"weights do not match the graph: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    return {k: torch.as_tensor(flat[k]).detach().to(device=device, dtype=getattr(torch, dtypes[k]))
            for k in dtypes}


# ----------------------------------------------------------------------
# export
# ----------------------------------------------------------------------


class _Bound(torch.nn.Module):
    """The pipeline's modules for one decoder, as submodules, so that
    `torch.func.functional_call` can replace their weights; forward is the
    pipeline's explain."""

    def __init__(self, pipe, decoder: str, masking):
        super().__init__()
        self.mods = torch.nn.ModuleDict({n: getattr(pipe, n) for n in _DECODER_MODULES[decoder]})
        object.__setattr__(self, "pipe", pipe)
        self.decoder, self.masking = decoder, masking

    def forward(self, wav):
        return tuple(self.pipe.explain(wav, decoder=self.decoder, masking=self.masking))


class _ExplainGraph(torch.nn.Module):
    """What `torch.export` traces: forward(params, wav), every weight taken
    from `params` (flat '/' keys). It holds the pipeline outside its
    attributes, so no weight becomes state of the exported program; the
    detector head and the static int8 scales, plain dicts on the pipeline,
    are swapped in for the call."""

    def __init__(self, pipe, decoder: str, masking):
        super().__init__()
        object.__setattr__(self, "_bound", _Bound(pipe, decoder, masking))

    def forward(self, params: dict, wav: torch.Tensor):
        tree = unflatten_params(params)
        pipe = self._bound.pipe
        state = {f"mods.{k.replace('/', '.')}": v for k, v in params.items()
                 if k.split("/", 1)[0] in self._bound.mods}
        saved = pipe.logreg, pipe.quant_scales
        pipe.logreg, pipe.quant_scales = tree["logreg"], tree.get("quant_scales")
        try:
            return torch.func.functional_call(self._bound, state, (wav,), strict=True)
        finally:
            pipe.logreg, pipe.quant_scales = saved


def export_explain(pipe, batch_size: int, decoder: str = "unet",
                   masking: MaskingConvention | str | None = None):
    """Trace `pipe.explain` at a fixed batch size on the pipeline's device ->
    (`torch.export.ExportedProgram`, the flat weights it takes). The program
    has signature (params {'a/b': tensor}, wav [batch, num_samples] f32) ->
    the `OUTPUT_FIELDS` tuple, and no state of its own."""
    masking = MaskingConvention(masking) if masking is not None else None
    flat = flatten_params(explain_params(pipe, decoder))
    wav = torch.zeros((batch_size, pipe.cfg.audio.num_samples), dtype=torch.float32,
                      device=pipe.device)
    with torch.no_grad(), paused():  # no span of the explain enters the graph
        program = torch.export.export(_ExplainGraph(pipe, decoder, masking), (flat, wav),
                                      strict=False)
    if program.state_dict:
        raise RuntimeError(f"the exported graph holds weights: {list(program.state_dict)[:5]}")
    # the example inputs are the weights themselves: `torch.export.save`
    # would write them into the graph's file
    program.example_inputs = None
    return program, flat


def graph_file(platform: str, default: str) -> str:
    """The file of `platform`'s graph in an artifact whose default device
    is `default`."""
    return _GRAPH_FILE if platform == default else f"explain.{platform}.pt2"


def pipeline_on(pipe, device: str):
    """`pipe` itself on its own device, else a pipeline of the same
    configuration on `device` holding its weights (every module's state,
    the detector head and the static int8 scales)."""
    from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline

    if torch.device(device).type == pipe.device.type:
        return pipe
    other = ADDvisorPipeline(pipe.cfg, device=device)
    for name in ("encoder", "unet", "feat_decoder"):
        getattr(other, name).load_state_dict(getattr(pipe, name).state_dict())
    dev = other.device
    other.logreg = {k: v.detach().to(dev) for k, v in pipe.logreg.items()}
    if pipe.quant_scales is not None:
        other.quant_scales = {k: torch.as_tensor(v).to(dev) for k, v in pipe.quant_scales.items()}
    return other


def save_exported(
    out_dir: str,
    pipe,
    batch_size: int,
    decoder: str = "unet",
    masking: MaskingConvention | str | None = None,
    platforms: tuple[str, ...] | None = None,
) -> str:
    """Write a self-contained serving artifact directory; returns its path.
    `platforms` (default: the pipeline's own device) names the devices to
    trace a graph for; the pipeline's device, if among them, is the
    default. Asking for cuda without a card raises before anything is
    written."""
    own = pipe.device.type
    platforms = tuple(dict.fromkeys(platforms or (own,)))
    bad = [p for p in platforms if p not in ("cuda", "cpu")]
    if bad:
        raise ValueError(f"unknown platforms {bad}: an artifact holds graphs for cuda and cpu")
    if "cuda" in platforms and not torch.cuda.is_available():
        raise ValueError(
            f"platforms {platforms} requested, but CUDA is not available here: a cuda graph is "
            "traced on the card. Export per-platform artifacts instead: --platforms cpu here "
            "(cli --device cpu export --platforms cpu), and the cuda one on a machine with a "
            "card (cli export --platforms cuda,cpu).")
    default = own if own in platforms else platforms[0]
    graphs = {p: export_explain(pipeline_on(pipe, p), batch_size, decoder, masking)
              for p in platforms}
    os.makedirs(out_dir, exist_ok=True)
    for p, (program, _) in graphs.items():
        torch.export.save(program, os.path.join(out_dir, graph_file(p, default)))
    flat = graphs[default][1]
    np.savez(os.path.join(out_dir, _PARAMS_FILE), **{k: _to_numpy(v) for k, v in flat.items()})
    eff_masking = MaskingConvention(masking) if masking is not None else pipe.cfg.masking
    meta = {
        "batch_size": batch_size,
        "num_samples": pipe.cfg.audio.num_samples,
        "sample_rate": pipe.cfg.audio.sample_rate,
        "clip_seconds": pipe.cfg.audio.clip_seconds,
        "decoder": decoder,
        "masking": str(getattr(eff_masking, "value", eff_masking)),
        "device": default,
        "platforms": list(platforms),
        "torch_version": torch.__version__,
        "param_dtypes": {k: str(v.dtype).removeprefix("torch.") for k, v in flat.items()},
    }
    with open(os.path.join(out_dir, _META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


# ----------------------------------------------------------------------
# load + run
# ----------------------------------------------------------------------


class ExportedExplain:
    """A loaded serving artifact: `__call__(wav[B, N]) -> ExplainOutput`-shaped
    tuple, no model code involved. The weights, placed on the graph's
    device once, can be swapped with `with_params`. It serves as the `pipe`
    of `serve/api.py` (`cfg.audio`, `device`)."""

    def __init__(self, program, params: dict, meta: dict, device: str | None = None):
        self._program = program
        self._module = program.module()
        self.meta = meta
        self.device = torch.device(device or meta["device"])
        self.params = _place(params, meta["param_dtypes"], self.device)
        self.batch_size = int(meta["batch_size"])
        self.num_samples = int(meta["num_samples"])
        self.decoder = meta["decoder"]
        self.cfg = types.SimpleNamespace(audio=AudioConfig(
            sample_rate=int(meta["sample_rate"]), clip_seconds=float(meta["clip_seconds"])))

    def __call__(self, wav) -> ExplainOutput:
        wav = torch.as_tensor(wav, dtype=torch.float32, device=self.device)
        if tuple(wav.shape) != (self.batch_size, self.num_samples):
            raise ValueError(
                f"exported graph is fixed-shape: expected "
                f"{(self.batch_size, self.num_samples)}, got {tuple(wav.shape)}"
            )
        with torch.inference_mode():
            return ExplainOutput(*self._module(self.params, wav.contiguous()))

    def with_params(self, params: dict) -> "ExportedExplain":
        """The same graph with other weights (nested as `explain_params`
        gives them, or flat), placed on the device once."""
        return ExportedExplain(self._program, params, self.meta, self.device.type)


def register_kernel_ops() -> None:
    """Import the kernels' registered ops, which a graph calls (no model
    code)."""
    from xai_audio_deepfakes_tpu_torch.ops import (  # noqa: F401
        attention,
        cuda_conv,
        cuda_ln_gelu,
        cuda_pos_conv,
        cuda_stft,
    )


def load_exported(artifact_dir: str, device: str | torch.device | None = None) -> ExportedExplain:
    """Load an artifact's graph for `device` (default: the device it was
    exported on). A device it holds no graph for raises, and so does a CUDA
    graph without CUDA."""
    register_kernel_ops()
    with open(os.path.join(artifact_dir, _META_FILE)) as f:
        meta = json.load(f)
    default = meta["device"]
    platforms = meta.get("platforms", [default])
    want = torch.device(device).type if device is not None else default
    if want != default and want not in platforms:
        raise ValueError(
            f"{artifact_dir} was exported for {', '.join(platforms)} and runs only there "
            f"(asked for {want}): export it with --platforms {want}")
    if want == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{artifact_dir} was exported for cuda, and CUDA is not available")
    program = torch.export.load(os.path.join(artifact_dir, graph_file(want, default)))
    with np.load(os.path.join(artifact_dir, _PARAMS_FILE)) as z:
        params = {k: z[k] for k in z.files}
    return ExportedExplain(program, params, meta, want)
