"""Parameter sharding by parameter path (port of `parallel/sharding.py`):
the Megatron split of the wav2vec2 embedder.

  * attention q/k/v kernels [H, H]:   output (head) dim split over model
  * attention out_proj kernel [H, H]: input dim split over model
  * ffn_in kernel [H, 4H]:            output dim split over model
  * ffn_out kernel [4H, H]:           input dim split over model
  * biases of the column-split layers split; out_proj / ffn_out biases
    replicated, added once after the all-reduce
  * everything else (LayerNorms, convs, projections) replicated

A spec is a tuple with one entry per leading dim of the leaf, an axis name
or None, as `PartitionSpec` reads (() replicates). The spec functions take
the JAX package's parameter tree (nested dicts of numpy arrays or tensors,
the layout `convert.load_encoder` reads), with the transformer layers
unrolled (`layer_{i}`, 2-D kernels) or stacked (`layers/layer`, a leading
[L] axis, `EmbedderConfig.scan_layers`). `shard_params` cuts such a tree to
this rank's blocks. `shard_encoder` cuts the port's encoder module the same
way (a flax kernel [in, out] is a torch weight [out, in], so a split of the
kernel's output dim splits the weight's rows): its layers then hold the
rank's heads and FFN columns, with an all-reduce after each row-split
product (`EncoderLayer.tensor_parallel`).
"""

from __future__ import annotations

import copy

import torch

from xai_audio_deepfakes_tpu_torch.config import MeshConfig
from xai_audio_deepfakes_tpu_torch.parallel.mesh import STAGE_AXIS, Mesh

_COLUMN = ("q_proj", "k_proj", "v_proj", "ffn_in")
_ROW = ("out_proj", "ffn_out")


def _spec_for_path(path: str, axis: str, ndim: int) -> tuple:
    """Kernel rank tells the unrolled (2-D) from the stacked (3-D) layout."""
    if any(name in path for name in _COLUMN):
        if path.endswith("kernel"):
            return (None, axis) if ndim == 2 else (None, None, axis)
        if path.endswith("bias"):
            return (axis,) if ndim == 1 else (None, axis)
    if any(name in path for name in _ROW):
        if path.endswith("kernel"):
            return (axis, None) if ndim == 2 else (None, axis, None)
        return ()
    return ()


def tree_map_with_path(fn, tree, prefix: str = ""):
    """fn(path, leaf) over nested dicts, the path '/'-joined."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def _leaves_with_path(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def embedder_param_specs(params: dict, cfg: MeshConfig = MeshConfig()) -> dict:
    """The tree of specs matching an encoder parameter tree."""
    return tree_map_with_path(lambda path, leaf: _spec_for_path(path, cfg.model_axis, leaf.ndim),
                              params)


def embedder_pp_param_specs(params: dict, n_stages: int = 0, stage_axis: str = STAGE_AXIS,
                            mesh_cfg: MeshConfig | None = None) -> dict:
    """Pipeline placement of a stacked (`scan_layers`) encoder tree: the
    layer stack ('layers/layer', leading [L]) split over `stage_axis` where
    L divides by the stage count, replicated otherwise; the frontend,
    projection and positional conv replicated. With
    `mesh_cfg.model_parallel > 1` the stacked kernels' Megatron dims split
    over the model axis too (dp x pp x tp)."""
    tp = mesh_cfg is not None and mesh_cfg.model_parallel > 1

    def spec(path, leaf):
        if "layers/layer" in path and n_stages and leaf.shape[0] % n_stages == 0:
            tail = _spec_for_path(path, mesh_cfg.model_axis, leaf.ndim)[1:] if tp else ()
            if not tail:
                tail = (None,) * (leaf.ndim - 1)
            return (stage_axis, *tail)
        return ()

    return tree_map_with_path(spec, params)


def embedder_pp_tp_param_specs(layer_params: dict, mesh_cfg: MeshConfig = MeshConfig(),
                               stage_axis: str = STAGE_AXIS) -> dict:
    """dp x pp x tp placement of a stacked layer tree (the
    `params['params']['layers']['layer']` subtree): the layer axis over
    `stage_axis`, each kernel's Megatron dims over the model axis."""
    specs = embedder_param_specs(layer_params, mesh_cfg)
    return tree_map_with_path(lambda _, s: (stage_axis, *s[1:]) if s else (stage_axis,), specs)


def _block(t, dim: int, index: int, size: int):
    """The index-th of `size` equal blocks of `t` along `dim`."""
    n = t.shape[dim]
    if n % size:
        raise ValueError(f"dim {dim} of size {n} does not split {size} ways")
    b = n // size
    return t[(slice(None),) * dim + (slice(index * b, (index + 1) * b),)]


def shard_leaf(t, spec: tuple, mesh: Mesh):
    """This rank's block of `t` under `spec`."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            t = _block(t, dim, mesh.index(axis), mesh.size(axis))
    return t


def shard_params(params: dict, mesh: Mesh, specs: dict | None = None) -> dict:
    """This rank's blocks of a parameter tree (replicated where a spec, or
    every spec when `specs` is None, says so)."""
    if specs is None:
        return tree_map_with_path(lambda _, leaf: leaf, params)
    flat = dict(_leaves_with_path(specs))
    return tree_map_with_path(lambda path, leaf: shard_leaf(leaf, flat[path], mesh), params)


def _torch_dim(spec: tuple) -> int | None:
    """The torch weight dim a 2-D flax kernel's spec splits (kernel [in, out]
    is weight [out, in])."""
    if not spec:
        return None
    return 0 if spec[1] is not None else 1


def shard_encoder(encoder, mesh: Mesh):
    """The rank's view of a `Wav2Vec2Encoder`: a copy of the module that
    shares every replicated parameter with `encoder`; with a model axis of
    more than one rank each layer holds its block of the q/k/v/out and FFN
    weights by `embedder_param_specs` (whole heads: the head count must
    divide), with a stage axis of more than one rank it keeps only its
    stage's contiguous block of layers (`embedder_pp_param_specs`: the layer
    count must divide; run it with `pipeline.pipelined_encoder_apply`)."""
    from xai_audio_deepfakes_tpu_torch.parallel.pipeline import stack_to_stages

    cfg, axis = encoder.cfg, mesh.cfg.model_axis
    tp, stages = mesh.size(axis), mesh.size(STAGE_AXIS)
    shared = {id(p): p for p in encoder.parameters()}
    shared.update({id(layer.tp_group): layer.tp_group for layer in encoder.layers})
    view = copy.deepcopy(encoder, shared)
    if stages > 1:
        if not cfg.scan_layers:
            raise ValueError("a pipeline over the layer stack needs scan_layers=True "
                             "(stacked [L, ...] layer params)")
        layers = stack_to_stages(list(view.layers), stages)
        n = len(layers) // stages
        i = mesh.index(STAGE_AXIS)
        view.layers = torch.nn.ModuleList(layers[i * n:(i + 1) * n])
        view.stage = (i, stages)
    if tp > 1:
        if cfg.quant != "none":
            raise ValueError("tensor parallelism takes the float transformer layers "
                             f"(quant={cfg.quant!r})")
        if cfg.num_heads % tp:
            raise ValueError(f"{cfg.num_heads} heads do not split {tp} ways")
        for layer in view.layers:
            layer.tensor_parallel(mesh.index(axis), tp, mesh.group(axis), megatron_splits(axis))
    return view


def megatron_splits(axis: str = "model") -> dict:
    """The Megatron split of `_spec_for_path` in torch layout:
    {projection: (the weight dim it splits or None, the bias dim or None)}."""
    return {name: (_torch_dim(_spec_for_path(f"{name}/kernel", axis, 2)),
                   0 if _spec_for_path(f"{name}/bias", axis, 1) else None)
            for name in _COLUMN + _ROW}
