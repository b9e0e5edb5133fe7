"""Training under the port's parallel layer on a gloo world of 8 CPU
processes, against the JAX package: tests/test_train.py's mesh tests (a
data-parallel step, a pipeline-parallel epoch and its refusal without
`scan_layers`), the training stages of `__graft_entry__.dryrun_multichip`
(dp x tp 4 x 2, pp x tp 2 x 2 x 2, forward and backward), BatchNorm's
statistics over a group of 2 against flax's over the whole batch, and the
CLI's three mesh flags running a job. One world for the file
(`tests/torch_parallel_cases.py`).

Bars: the JAX data-parallel test's (the loss rtol 1e-4, the decoder's
parameters after the step atol 1.5e-4: a gradient that is zero up to
rounding may take either sign, and Adam moves its parameter by up to
2 lr = 6e-5 either way), the port's train step test's for the loss terms
(1e-5), the loss weights (1e-6) and the batch statistics (1e-5); f32
tolerance for BatchNorm.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_train import jax_step_and_grads, make_jax_params
from tests.torch_parallel_cases import run_world
from xai_audio_deepfakes_tpu_torch.data.io import write_wav

WORLD = 8
CASES = ["train_data_parallel", "train_dp_tp", "train_pp_tp", "train_pipeline_epoch",
         "batch_norm_group", "cli_jobs"]
NAMES = tuple(f"c{i}.wav" for i in range(8))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Beside the suite's other workers: one intra-op thread here too (the
    spawned ranks take one each)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_train")
    rng = np.random.default_rng(6)
    root = tmp / "corpus"
    root.mkdir()
    for name in NAMES:
        write_wav(str(root / name), rng.uniform(-0.3, 0.3, 8000), 16000)
    (root / "meta.csv").write_text("".join(f"{n},bonafide\n" for n in NAMES))
    bn = np.random.default_rng(9)
    payload = {
        "train_params": make_jax_params(),
        "train_wav": np.random.default_rng(3).standard_normal((8, 8000)).astype(np.float32) * 0.1,
        "bn_x": (bn.standard_normal((4, 6, 9, 7)) * 2 + 0.5).astype(np.float32),
        "bn_scale": bn.standard_normal(6).astype(np.float32),
        "bn_bias": bn.standard_normal(6).astype(np.float32),
        "cli_meta": str(root / "meta.csv"), "cli_root": str(root), "cli_out": str(tmp / "cli"),
    }
    ranks = run_world(WORLD, payload, CASES, str(tmp))
    return {"payload": payload, "ranks": ranks}


def result(ref, case: str, rank: int = 0):
    status, value = ref["ranks"][rank][case]
    assert status == "ok", value
    return value


@pytest.fixture(scope="module")
def jax_step(ref):
    """JAX's jitted step on the whole batch of 8."""
    p = ref["payload"]
    params = jax.tree.map(jnp.asarray, p["train_params"])
    state, aux, _ = jax_step_and_grads(params, jnp.asarray(p["train_wav"]))
    return state, aux


def _trees_close(got: dict, want, atol: float, what: str) -> None:
    flat_w = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, want)))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert flat_g.keys() == flat_w.keys(), what
    for path, w in flat_w.items():
        np.testing.assert_allclose(flat_g[path], w, atol=atol,
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("case", ["train_data_parallel", "train_dp_tp", "train_pp_tp"])
def test_mesh_train_step_matches_single_device(ref, jax_step, case):
    """One step on a (8, 1, 1), (4, 1, 2) or (2, 2, 2) mesh against JAX's
    unsharded step on the same batch: every rank the same state after it."""
    state, aux = jax_step
    for rank in range(WORLD):
        res = result(ref, case, rank)
        np.testing.assert_allclose(res["aux"]["loss"], float(aux["loss"]), rtol=1e-4)
        np.testing.assert_allclose(res["aux"]["loss_vec"], np.asarray(aux["loss_vec"]), atol=1e-5)
        np.testing.assert_allclose(res["w_raw"], np.asarray(state.w_raw), atol=1e-6)
        _trees_close(res["batch_stats"], state.unet_batch_stats, 1e-5, f"{case} batch_stats")
        _trees_close(res["unet_params"], state.unet_params, 1.5e-4, f"{case} params")


def test_pipeline_parallel_training_matches_single_device(ref, jax_step):
    """`train_addvisor` on a (4, 2, 1) mesh over one epoch of one batch: its
    record's loss is JAX's step's (rtol 1e-4); without scan_layers the stage
    axis is refused."""
    _, aux = jax_step
    for rank in range(WORLD):
        res = result(ref, "train_pipeline_epoch", rank)
        np.testing.assert_allclose(res["loss"], float(aux["loss"]), rtol=1e-4)
        assert "scan_layers" in res["refusal"]


def test_batch_norm_statistics_over_a_group_match_flax(ref):
    """BatchNorm2d in training mode over a gloo group of 2, each rank half of
    the batch, against flax's nn.BatchNorm on the whole batch: outputs,
    running statistics, and the gradients of sum(y^3) (x's per rank, the
    scale's and bias's summed over the two ranks)."""
    p = ref["payload"]
    x = jnp.asarray(p["bn_x"].transpose(0, 2, 3, 1))
    bn = nn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-5, dtype=jnp.float32)
    variables = {"params": {"scale": jnp.asarray(p["bn_scale"]), "bias": jnp.asarray(p["bn_bias"])},
                 "batch_stats": {"mean": jnp.zeros(6), "var": jnp.ones(6)}}
    y, upd = bn.apply(variables, x, mutable=["batch_stats"])

    def loss(params, x):
        return jnp.sum(bn.apply({**variables, "params": params}, x, mutable=["batch_stats"])[0] ** 3)

    gp, gx = jax.grad(loss, argnums=(0, 1))(variables["params"], x)
    y, gx = np.asarray(y).transpose(0, 3, 1, 2), np.asarray(gx).transpose(0, 3, 1, 2)
    ranks = [result(ref, "batch_norm_group", r) for r in range(2)]
    assert all(result(ref, "batch_norm_group", r) is None for r in range(2, WORLD))
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks]), y, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([r["gx"] for r in ranks]), gx,
                               atol=1e-5 * float(np.abs(gx).max()))
    for r in ranks:
        np.testing.assert_allclose(r["mean"], np.asarray(upd["batch_stats"]["mean"]), atol=1e-6)
        np.testing.assert_allclose(r["var"], np.asarray(upd["batch_stats"]["var"]), atol=1e-6)
    for key, want in (("gw", gp["scale"]), ("gb", gp["bias"])):
        np.testing.assert_allclose(sum(r[key] for r in ranks), np.asarray(want),
                                   rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def test_cli_mesh_flags_run_their_jobs(ref):
    """The CLI's --model-parallel (eval), --data-parallel with
    --model-parallel (train) and --pipeline-stages (closed-loop) on the
    world of 8: rank 0 prints what the same job without the flags prints,
    at the sweep's bars (rtol 1e-4, atol 1e-5), the trained decoder within
    1.5e-4 of the unsharded one, the closed loop's detector equal and its
    epoch loss at rtol 1e-4; the other ranks print nothing."""
    res = result(ref, "cli_jobs")
    sharded, plain = res["eval"]
    assert sharded.keys() == plain.keys() and sharded["num_clips"] == plain["num_clips"] == 8
    for k, v in plain.items():
        np.testing.assert_allclose(sharded[k], v, rtol=1e-4, atol=1e-5, err_msg=k)
    assert res["train_mesh"] == res["train_plain"] == {"trained_steps": 1}
    for k, v in res["decoder_plain"].items():
        np.testing.assert_allclose(res["decoder_mesh"][k], v, atol=1.5e-4, err_msg=k)
    mesh_cl, plain_cl = res["closed_loop"]
    assert mesh_cl["detector"] == plain_cl["detector"]
    np.testing.assert_allclose(mesh_cl["train_log"][0]["loss"], plain_cl["train_log"][0]["loss"],
                               rtol=1e-4)
    for rank in range(1, WORLD):
        other = result(ref, "cli_jobs", rank)
        assert other["eval"][0] is None and other["train_mesh"] is None
        assert other["closed_loop"][0] is None
        assert other["eval"][1] == plain


@pytest.mark.parametrize("unet_dtype", ["float32", "bfloat16"])
def test_mesh_step_at_world_one_is_the_plain_step(unet_dtype):
    """At one rank the mesh step is the plain step, by construction (the
    same BatchNorm code, no collective at a group of one): two steps' losses,
    decoder gradients and parameters bit for bit, in f32 and with the bf16
    UNet. (On the card: chip_smoke.py's parallel phase (c).)"""
    import torch

    from tests.torch_parallel_cases import tiny, world_of_one
    from xai_audio_deepfakes_tpu_torch import config as tc
    from xai_audio_deepfakes_tpu_torch.parallel.inference import shard_pipeline_params
    from xai_audio_deepfakes_tpu_torch.parallel.mesh import make_mesh
    from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline
    from xai_audio_deepfakes_tpu_torch.train.train_addvisor import init_train_state, make_train_step

    cfg = tiny().replace(unet=tc.UNetConfig(freq_bins=64, frames=24, base_channels=4,
                                            dtype=unet_dtype))
    wavs = np.random.default_rng(4).standard_normal((2, 2, 8000)).astype(np.float32) * 0.1
    runs = []
    for sharded in (False, True):
        pipe = ADDvisorPipeline(cfg, device="cpu", seed=3)
        with world_of_one():
            mesh = make_mesh(tc.MeshConfig(), "cpu") if sharded else None
            view = shard_pipeline_params(pipe, mesh) if sharded else pipe
            state, step = init_train_state(view), make_train_step(view, mesh=mesh)
            seen = []
            for wav in wavs:
                _, aux = step(state, wav)
                seen.append((aux["loss_vec"].clone(),
                             [p.grad.clone() for p in pipe.unet.parameters()]))
            runs.append((seen, [p.detach().clone() for p in pipe.unet.parameters()]))
    (plain, plain_p), (mesh_run, mesh_p) = runs
    for (lv_a, g_a), (lv_b, g_b) in zip(plain, mesh_run):
        assert torch.equal(lv_a, lv_b)
        assert all(torch.equal(a, b) for a, b in zip(g_a, g_b))
    assert all(torch.equal(a, b) for a, b in zip(plain_p, mesh_p))
