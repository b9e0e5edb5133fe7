"""The parallel layer (port of `parallel/`): the device mesh, the Megatron
split of the embedder, the GPipe pipeline over its layer stack and the
sharded explain, on `torch.distributed`."""

from xai_audio_deepfakes_tpu_torch.parallel.mesh import (
    batch_sharding,
    initialize_distributed,
    make_mesh,
    replicated,
)
from xai_audio_deepfakes_tpu_torch.parallel.pipeline import (
    encoder_layer_fn,
    pipeline_apply,
    pipelined_encoder_apply,
    stack_to_stages,
)
from xai_audio_deepfakes_tpu_torch.parallel.sharding import (
    embedder_param_specs,
    shard_params,
)
