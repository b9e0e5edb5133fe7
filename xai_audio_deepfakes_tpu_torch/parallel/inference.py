"""The sharded explain (port of `parallel/inference.py`): the batch over
the data axis, the embedder's Megatron split over the model axis
(`parallel/sharding.py`), its layer stack over the stage axis
(`parallel/pipeline.py`); everything else replicated.

    mesh = make_mesh(MeshConfig(model_parallel=2), device="cuda")
    explain, sharded = make_sharded_explain(pipe, mesh)
    out = explain(wav)   # the whole batch in, the whole batch out

Every rank calls `explain` with the same batch and gets the same
`ExplainOutput`: it explains its data shard, and the shards' outputs are
gathered over the data axis.
"""

from __future__ import annotations

import copy

import torch

from xai_audio_deepfakes_tpu_torch.config import MaskingConvention
from xai_audio_deepfakes_tpu_torch.parallel.mesh import (
    STAGE_AXIS,
    Mesh,
    batch_sharding,
    gather_batch,
    replicated,
)
from xai_audio_deepfakes_tpu_torch.parallel.sharding import shard_encoder


def _pp_stages(mesh: Mesh) -> int:
    return mesh.size(STAGE_AXIS)


def shard_pipeline_params(pipe, mesh: Mesh):
    """The rank's view of the pipeline: a shallow copy whose encoder is the
    rank's shard (`shard_encoder`: tensor-parallel layers over the model
    axis, or the stage's layers over the stage axis, run through
    `pipelined_encoder_apply` as `features_fn`), every other module shared
    with `pipe`. Before the split every parameter and buffer is made equal
    to global rank 0's (`replicated`), as JAX places one host tree on every
    device."""
    from xai_audio_deepfakes_tpu_torch.parallel.pipeline import pipelined_encoder_apply

    with torch.no_grad():
        for module in (pipe.encoder, pipe.unet, pipe.feat_decoder):
            for t in list(module.parameters()) + list(module.buffers()):
                replicated(mesh, t.data)
        for t in pipe.logreg.values():
            replicated(mesh, t.data)
    view = copy.copy(pipe)
    view.encoder = shard_encoder(pipe.encoder, mesh)
    if _pp_stages(mesh) > 1:
        cfg = pipe.cfg.embedder
        view.features_fn = lambda encoder, norm_wav: pipelined_encoder_apply(
            cfg, encoder, norm_wav, mesh)
    return view


def make_sharded_explain(pipe, mesh: Mesh, decoder: str = "unet",
                         masking: MaskingConvention | None = None):
    """-> (explain(wav) -> ExplainOutput, the rank's pipeline view). The
    batch must divide by the data axis's size (and each shard by the
    pipeline's microbatch count, the stage count by default); a pipeline
    over stages needs `scan_layers`."""
    if _pp_stages(mesh) > 1 and not pipe.cfg.embedder.scan_layers:
        raise ValueError("pipeline-parallel explain needs scan_layers=True "
                         "(stacked [L, ...] layer params)")
    sharded = shard_pipeline_params(pipe, mesh)

    @torch.inference_mode()
    def explain(wav):
        local = batch_sharding(mesh, sharded._as_input(wav))
        out = sharded.explain(local, decoder, masking)
        return type(out)(*(gather_batch(mesh, t) for t in out))

    return explain, sharded
