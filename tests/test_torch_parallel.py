"""The parallel layer of the port (`parallel/`: mesh, Megatron split,
GPipe pipeline, sharded explain and sweep, DCP checkpoint) on a gloo world
of 8 CPU processes, against the JAX package on its 8-virtual-device mesh's
own cases: the 11 tests of tests/test_pipeline_parallel.py, the
tensor-parallel embedder of tests/test_train.py, and the sharded eval with
a checkpoint of `__graft_entry__.dryrun_multichip`. The world is spawned
once for the file (`tests/torch_parallel_cases.py` runs every case on every
rank); the JAX references run here, at the JAX package's bars: 1e-5 for
forwards, rtol 1e-4 / atol 1e-3 for gradients, the explain's waveforms
1e-4, the sweep rtol 1e-4 / atol 1e-5.

The port's meshes hold every rank: the JAX cases' (data, stage, model)
shapes of 8 devices run as they are; a (2, 2) case of 4 devices runs as
(4, 2, 1) with a batch that gives each data shard whole microbatches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from tests.test_pipeline import tiny_config
from tests.test_torch_models import random_params
from tests.test_torch_train import make_jax_params
from tests.torch_parallel_cases import run_world
from xai_audio_deepfakes_tpu.config import EmbedderConfig, MeshConfig
from xai_audio_deepfakes_tpu.metrics.harness import run_explanation_metrics as j_sweep
from xai_audio_deepfakes_tpu.models.wav2vec2 import Wav2Vec2Encoder
from xai_audio_deepfakes_tpu.parallel import sharding as js
from xai_audio_deepfakes_tpu.parallel.pipeline import encoder_layer_fn
from xai_audio_deepfakes_tpu.pipeline.core import ADDvisorPipeline as JPipeline
from xai_audio_deepfakes_tpu_torch import config as tc
from xai_audio_deepfakes_tpu_torch.parallel import sharding as ts

WORLD = 8
CASES = ["pipeline_matches_sequential", "pipeline_single_stage",
         "pipeline_schedule_and_gradients", "pipeline_remat", "pipeline_validation",
         "pipeline_tp", "pipelined_encoder", "sharded_explain", "tensor_parallel_embedder",
         "sharded_sweep_and_checkpoint", "mesh_errors"]


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The payload, JAX's references, and every rank's results."""
    cfg8 = dataclasses.replace(EmbedderConfig.tiny(), num_layers=8, scan_layers=True)
    stacked = random_params(Wav2Vec2Encoder(cfg8).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 1600)), seed=0)
    cfg4 = dataclasses.replace(EmbedderConfig.tiny(), num_layers=4, scan_layers=True,
                               output_layer=9)
    enc4 = random_params(Wav2Vec2Encoder(cfg4).init, jax.random.PRNGKey(0),
                         jnp.zeros((1, 3200)), seed=4)
    tmp = tmp_path_factory.mktemp("parallel")
    payload = {
        "stacked_params": stacked,
        "x": _rng(1).standard_normal((16, 12, cfg8.hidden_size)).astype(np.float32),
        "enc4_params": enc4,
        "enc4_wav": _rng(3).standard_normal((8, 3200)).astype(np.float32),
        "tiny": make_jax_params(),
        "wav8": _rng(5).standard_normal((8, 8000)).astype(np.float32) * 0.1,
        "wav4": _rng(7).standard_normal((4, 8000)).astype(np.float32) * 0.1,
        "sweep0": _rng(5).standard_normal((8, 8000)).astype(np.float32) * 0.1,
        "sweep1": _rng(6).standard_normal((8, 8000)).astype(np.float32) * 0.1,
        "ckpt_dir": str(tmp / "ckpt"),
    }
    ranks = run_world(WORLD, payload, CASES, str(tmp))
    return {"payload": payload, "ranks": ranks, "cfg8": cfg8, "cfg4": cfg4}


def result(ref, case: str, rank: int = 0):
    status, value = ref["ranks"][rank][case]
    assert status == "ok", value
    return value


@pytest.fixture(scope="module")
def sequential(ref):
    """JAX's scan over the 8 stacked layers, and the gradients of
    sum(out^2) with respect to the layers and x."""
    layer_fn = encoder_layer_fn(ref["cfg8"])
    params = jax.tree.map(jnp.asarray, ref["payload"]["stacked_params"]["params"]["layers"]["layer"])
    x = jnp.asarray(ref["payload"]["x"])

    def seq(p, x):
        return jax.lax.scan(lambda h, q: (layer_fn(q, h), None), x, p)[0]

    out = jax.jit(seq)(params, x)
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(seq(p, x) ** 2), argnums=(0, 1)))(params, x)
    return np.asarray(out), jax.tree.map(np.asarray, gp), np.asarray(gx)


def _block(a: np.ndarray, spec: tuple, coords: dict) -> np.ndarray:
    for dim, axis in enumerate(spec):
        if axis is not None:
            i, n = coords[axis]
            b = a.shape[dim] // n
            a = a[(slice(None),) * dim + (slice(i * b, (i + 1) * b),)]
    return a


def check_stage_grads(ref, case: str, gp: dict, tp: bool) -> None:
    """Each rank's layer gradients (its stage's layers, its Megatron block
    under tp) against the block of JAX's stacked gradients its placement
    names (`embedder_pp_tp_param_specs`)."""
    mesh_cfg = MeshConfig(model_parallel=2 if tp else 1)
    specs = js.embedder_pp_tp_param_specs(gp, mesh_cfg) if tp else jax.tree.map(
        lambda a: P("stage"), gp)
    flat_specs = {jax.tree_util.keystr(k): tuple(v) for k, v in
                  jax.tree_util.tree_leaves_with_path(specs, is_leaf=lambda s: isinstance(s, P))}
    for rank in range(WORLD):
        res = result(ref, case, rank)
        coords = res["coords"]
        for path, g in jax.tree_util.tree_leaves_with_path(gp):
            key = jax.tree_util.keystr(path)
            want = _block(g, flat_specs[key], coords)
            got = np.stack([_get(layer, path) for layer in res["g_layers"]])
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3, err_msg=f"{rank}{key}")


def _get(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.mark.parametrize("dp,pp,n_micro", [(2, 4, 4), (2, 4, 8), (1, 8, 8)])
def test_pipeline_matches_sequential(ref, sequential, dp, pp, n_micro):
    for rank in range(WORLD):
        got = result(ref, "pipeline_matches_sequential", rank)[(dp, pp, n_micro)]
        np.testing.assert_allclose(got, sequential[0], atol=1e-5)


def test_pipeline_single_stage_degenerate(ref, sequential):
    np.testing.assert_allclose(result(ref, "pipeline_single_stage"), sequential[0], atol=1e-5)


def test_pipeline_jit_compiles_once(ref, sequential):
    """JAX's jitted rotation against eager becomes the port's schedule run
    without a graph against the differentiable one: bit for bit, and at the
    forward bar against the sequential scan."""
    for rank in range(WORLD):
        res = result(ref, "pipeline_schedule_and_gradients", rank)
        assert res["same"]
        np.testing.assert_allclose(res["plain"], sequential[0], atol=1e-5)


def test_pipeline_gradients_match_sequential(ref, sequential):
    _, gp, gx = sequential
    for rank in range(WORLD):
        res = result(ref, "pipeline_schedule_and_gradients", rank)
        np.testing.assert_allclose(res["gx"], gx, rtol=1e-4, atol=1e-3)
    check_stage_grads(ref, "pipeline_schedule_and_gradients", gp, tp=False)


@pytest.mark.parametrize("output_layer", [9, 2])
def test_pipelined_encoder_matches_plain_apply(ref, output_layer):
    cfg = dataclasses.replace(ref["cfg4"], output_layer=output_layer)
    params = jax.tree.map(jnp.asarray, ref["payload"]["enc4_params"])
    want = np.asarray(Wav2Vec2Encoder(cfg).apply(params, jnp.asarray(ref["payload"]["enc4_wav"])))
    for rank in range(WORLD):
        got = result(ref, "pipelined_encoder", rank)[output_layer]
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.fixture(scope="module")
def jax_explain(ref):
    jpipe = JPipeline(tiny_config())
    params = jax.tree.map(jnp.asarray, ref["payload"]["tiny"])
    fn = jax.jit(lambda p, w: jpipe.explain(p, w, decoder="unet"))
    return {k: fn(params, jnp.asarray(ref["payload"][k])) for k in ("wav8", "wav4")}


def _check_explain(got: dict, want) -> None:
    for key in ("probs_clean", "probs_relevant", "probs_irrelevant"):
        np.testing.assert_allclose(got[key], np.asarray(getattr(want, key)), atol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(got["relevant_wav"], np.asarray(want.relevant_wav), atol=1e-4)
    np.testing.assert_allclose(got["irrelevant_wav"], np.asarray(want.irrelevant_wav), atol=1e-4)
    np.testing.assert_allclose(got["mask"], np.asarray(want.mask), atol=1e-5)


def test_sharded_explain_with_pipeline_stages_matches_single_device(ref, jax_explain):
    for rank in range(WORLD):
        _check_explain(result(ref, "sharded_explain", rank)["pp"], jax_explain["wav8"])
    assert "scan_layers" in result(ref, "sharded_explain")["refusal"]


def test_pipeline_validation_errors(ref):
    res = result(ref, "pipeline_validation")
    assert "not divisible" in res["stages"]
    assert "batch" in res["batch"]
    assert "pipelined_encoder_apply" in res["stage_forward"]


def test_pipeline_remat_matches_and_grads(ref):
    for rank in range(WORLD):
        res = result(ref, "pipeline_remat", rank)
        for policy in ("full", "dots"):
            got = jax.tree.leaves(res[policy])
            want = jax.tree.leaves(res["off"])
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3, err_msg=policy)
        assert "remat_policy" in res["bad_policy"]


def test_pipeline_composes_with_tensor_parallel(ref, sequential):
    for rank in range(WORLD):
        res = result(ref, "pipeline_tp", rank)
        np.testing.assert_allclose(res["fwd"], sequential[0], atol=1e-5)
        assert res["local_ffn_in"] == (ref["cfg8"].intermediate_size // 2, ref["cfg8"].hidden_size)


def test_pipeline_tp_gradients_match_sequential(ref, sequential):
    _, gp, gx = sequential
    for rank in range(WORLD):
        np.testing.assert_allclose(result(ref, "pipeline_tp", rank)["gx"], gx, rtol=1e-4,
                                   atol=1e-3)
    check_stage_grads(ref, "pipeline_tp", gp, tp=True)


def test_sharded_explain_dp_pp_tp_matches_single_device(ref, jax_explain):
    for rank in range(WORLD):
        _check_explain(result(ref, "sharded_explain", rank)["pp_tp"], jax_explain["wav4"])


def test_sharded_explain_tensor_parallel_matches_single_device(ref, jax_explain):
    for rank in range(WORLD):
        _check_explain(result(ref, "sharded_explain", rank)["tp"], jax_explain["wav8"])


def test_tensor_parallel_embedder_specs(ref):
    """tests/test_train.py's: the embedder Megatron-split two ways under a
    (4, 1, 2) mesh against the whole embedder's JAX forward (1e-4); the FFN
    and the heads are split on every rank."""
    jpipe = JPipeline(tiny_config())
    params = jax.tree.map(jnp.asarray, ref["payload"]["tiny"]["encoder"])
    want = np.asarray(jpipe.encoder.apply(params, jnp.asarray(ref["payload"]["wav8"])))
    cfg = tiny_config().embedder
    for rank in range(WORLD):
        res = result(ref, "tensor_parallel_embedder", rank)
        np.testing.assert_allclose(res["feats"], want, atol=1e-4)
        assert res["ffn_in"] == (cfg.intermediate_size // 2, cfg.hidden_size)
        assert res["ffn_out"] == (cfg.hidden_size, cfg.intermediate_size // 2)
        assert res["nh"] == cfg.num_heads // 2 and res["q"][1] == cfg.hidden_size
        assert res["whole_ffn_in"] == (cfg.intermediate_size, cfg.hidden_size)


def test_sharded_sweep_and_checkpoint(ref):
    """`dryrun_multichip`'s eval stage: the sweep on a (4, 1, 2) mesh against
    the JAX package's unsharded sweep (rtol 1e-4, atol 1e-5) and the port's
    own, and the embedder's Megatron blocks through
    `torch.distributed.checkpoint` and back, bit for bit with their shapes."""
    p = ref["payload"]
    want = j_sweep(JPipeline(tiny_config()), jax.tree.map(jnp.asarray, p["tiny"]),
                   [p["sweep0"], p["sweep1"]])
    for rank in range(WORLD):
        res = result(ref, "sharded_sweep_and_checkpoint", rank)
        for k, v in want.items():
            np.testing.assert_allclose(res["sharded"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)
            np.testing.assert_allclose(res["sharded"][k], res["local"][k], rtol=1e-4, atol=1e-5)
        assert res["ckpt_equal"]
        assert ".metadata" in res["ckpt_files"]


def test_mesh_product_must_be_the_world(ref):
    assert "world has 8" in result(ref, "mesh_errors")["product"]


def test_param_specs_match_jax():
    """The spec functions on the JAX package's own trees, unrolled and
    stacked: the same specs entry by entry."""
    jcfg = MeshConfig(model_parallel=2)
    mine = tc.MeshConfig(model_parallel=2)
    unrolled = random_params(JPipeline(tiny_config()).encoder.init, jax.random.PRNGKey(0),
                             jnp.zeros((1, 8000)), seed=1)
    cfg8 = dataclasses.replace(EmbedderConfig.tiny(), num_layers=8, scan_layers=True)
    stacked = random_params(Wav2Vec2Encoder(cfg8).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 1600)), seed=0)
    layer = stacked["params"]["layers"]["layer"]
    pairs = [
        (js.embedder_param_specs(unrolled, jcfg), ts.embedder_param_specs(unrolled, mine)),
        (js.embedder_param_specs(stacked, jcfg), ts.embedder_param_specs(stacked, mine)),
        (js.embedder_pp_param_specs(stacked, 4), ts.embedder_pp_param_specs(stacked, 4)),
        (js.embedder_pp_param_specs(stacked, 4, mesh_cfg=jcfg),
         ts.embedder_pp_param_specs(stacked, 4, mesh_cfg=mine)),
        (js.embedder_pp_param_specs(stacked, 3), ts.embedder_pp_param_specs(stacked, 3)),
        (js.embedder_pp_tp_param_specs(layer, jcfg), ts.embedder_pp_tp_param_specs(layer, mine)),
    ]
    for want, got in pairs:
        flat = jax.tree_util.tree_leaves_with_path(want, is_leaf=lambda s: isinstance(s, P))
        assert len(flat) > 10
        for path, spec in flat:
            assert _get(got, path) == tuple(spec), jax.tree_util.keystr(path)
    split = [k for k, s in jax.tree_util.tree_leaves_with_path(pairs[0][0],
                                                               is_leaf=lambda s: isinstance(s, P))
             if s != P()]
    assert any("ffn_in" in jax.tree_util.keystr(k) for k in split)
