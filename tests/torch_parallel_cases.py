"""The port's side of tests/test_torch_parallel*.py: cases that run on every
rank of a gloo world spawned once per test file (`run_world`), on the CPU,
one torch thread a rank. Nothing here imports JAX: the test files hold each
rank's results against the JAX package in the parent process.

A case is a function of the payload (numpy weights and inputs drawn by the
parent) returning this rank's results, numpy arrays or plain values; each
case builds the meshes it needs over the whole world.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist

from xai_audio_deepfakes_tpu_torch import config as tc
from xai_audio_deepfakes_tpu_torch.convert import load_encoder, load_jax_params
from xai_audio_deepfakes_tpu_torch.models.wav2vec2 import HeadDense, Wav2Vec2Encoder
from xai_audio_deepfakes_tpu_torch.parallel.mesh import (
    batch_sharding,
    gather_batch,
    initialize_distributed,
    make_mesh,
)
from xai_audio_deepfakes_tpu_torch.parallel.pipeline import (
    encoder_layer_fn,
    pipeline_apply,
    pipelined_encoder_apply,
    stack_to_stages,
)
from xai_audio_deepfakes_tpu_torch.parallel.sharding import shard_encoder
from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline

TINY_UNET = dict(freq_bins=64, frames=24, base_channels=4)


def tiny(**embedder) -> tc.PipelineConfig:
    """tests/test_pipeline.py::tiny_config in the port's config."""
    return tc.PipelineConfig(
        audio=tc.AudioConfig(clip_seconds=0.5),
        embedder=dataclasses.replace(tc.EmbedderConfig.tiny(), **embedder),
        unet=tc.UNetConfig(**TINY_UNET),
        feat_decoder=tc.FeatDecoderConfig(feature_dim=32, hidden=16))


def mesh_of(dp: int, pp: int, tp: int):
    return make_mesh(tc.MeshConfig(model_parallel=tp), "cpu", pipeline_stages=pp,
                     data_parallel=dp)


def coords(mesh) -> dict:
    return {axis: (mesh.index(axis), mesh.size(axis)) for axis in mesh.axes}


def np_(t) -> np.ndarray:
    return t.detach().float().numpy().copy()


def layer_to_jax(layer, grad: bool = False) -> dict:
    """An `EncoderLayer`'s parameters (or their gradients) in the JAX tree's
    layout, head padding removed; a tensor-parallel layer gives its block."""
    def get(p):
        return p.grad if grad else p

    out = {}
    for name in ("attn_ln", "ffn_ln"):
        ln = getattr(layer, name)
        out[name] = {"scale": np_(get(ln.weight)), "bias": np_(get(ln.bias))}
    for name in ("q_proj", "k_proj", "v_proj", "out_proj", "ffn_in", "ffn_out"):
        d = getattr(layer, name)
        w, b = get(d.weight), get(d.bias)
        if isinstance(d, HeadDense):
            nh, hd, hdp = d.nh, d.hd, d.hdp
            if d.pad_axis == 1:
                w = w.reshape(nh, hdp, -1)[:, :hd].reshape(nh * hd, -1)
                b = b.reshape(nh, hdp)[:, :hd].reshape(-1)
            else:
                w = w.reshape(w.shape[0], nh, hdp)[:, :, :hd].reshape(w.shape[0], nh * hd)
        out[name] = {"kernel": np_(w).T.copy(), "bias": np_(b)}
    return out


def stacked_encoder(p) -> Wav2Vec2Encoder:
    """The 8 stacked tiny layers of test_pipeline_parallel.py's `stacked`."""
    cfg = dataclasses.replace(tc.EmbedderConfig.tiny(), num_layers=8, output_layer=8,
                              scan_layers=True)
    enc = Wav2Vec2Encoder(cfg, torch.Generator().manual_seed(0), "cpu")
    load_encoder(enc, p["stacked_params"]["params"])
    return enc


def _pipe(p, key: str, **embedder) -> ADDvisorPipeline:
    pipe = ADDvisorPipeline(tiny(**embedder), device="cpu", seed=0)
    load_jax_params(pipe, p[key])
    return pipe


# ---------------------------------------------------------------------------
# tests/test_pipeline_parallel.py
# ---------------------------------------------------------------------------


def case_pipeline_matches_sequential(p):
    enc = stacked_encoder(p)
    x = torch.from_numpy(p["x"])
    out = {}
    for dp, pp, n_micro in ((2, 4, 4), (2, 4, 8), (1, 8, 8)):
        mesh = mesh_of(dp, pp, 1)
        view = shard_encoder(enc, mesh)
        with torch.no_grad():
            got = pipeline_apply(encoder_layer_fn(enc.cfg), view.layers, batch_sharding(mesh, x),
                                 mesh, n_micro=n_micro)
        out[(dp, pp, n_micro)] = np_(gather_batch(mesh, got))
    return out


def case_pipeline_single_stage(p):
    enc = stacked_encoder(p)
    mesh = mesh_of(8, 1, 1)
    with torch.no_grad():
        got = pipeline_apply(encoder_layer_fn(enc.cfg), enc.layers,
                             batch_sharding(mesh, torch.from_numpy(p["x"])), mesh, n_micro=2)
    return np_(gather_batch(mesh, got))


def _stacked_grads(enc, view, mesh, x, n_micro, layer_fn=None):
    """d sum(pipeline(x)^2) / d (x, the stage's layers), the layer
    gradients summed over the data axis -> (x grad gathered, [layers in
    JAX layout], coordinates)."""
    for q in enc.parameters():
        q.grad = None
    xs = batch_sharding(mesh, x).clone().requires_grad_(True)
    out = pipeline_apply(layer_fn or encoder_layer_fn(enc.cfg), view.layers, xs, mesh,
                         n_micro=n_micro)
    (out ** 2).sum().backward()
    group = mesh.group("data")
    for layer in view.layers:
        for q in layer.parameters():
            dist.all_reduce(q.grad, group=group)
    return (np_(gather_batch(mesh, xs.grad)), [layer_to_jax(l, grad=True) for l in view.layers],
            coords(mesh))


def case_pipeline_schedule_and_gradients(p):
    """The no-graph schedule against the differentiable one (JAX's jit
    against eager), then the gradients on a (2, 4) mesh."""
    enc = stacked_encoder(p)
    x = torch.from_numpy(p["x"])
    mesh = mesh_of(2, 4, 1)
    view = shard_encoder(enc, mesh)
    fn = encoder_layer_fn(enc.cfg)
    with torch.inference_mode():
        plain = pipeline_apply(fn, view.layers, batch_sharding(mesh, x), mesh, n_micro=4)
    xs = batch_sharding(mesh, x).clone().requires_grad_(True)
    graphed = pipeline_apply(fn, view.layers, xs, mesh, n_micro=4)
    res = {"plain": np_(gather_batch(mesh, plain.clone())),
           "same": bool(torch.equal(plain, graphed.detach()))}
    res["gx"], res["g_layers"], res["coords"] = _stacked_grads(enc, view, mesh, x, 4)
    return res


def case_pipeline_remat(p):
    enc = stacked_encoder(p)
    x = torch.from_numpy(p["x"])
    mesh = mesh_of(2, 4, 1)
    view = shard_encoder(enc, mesh)
    res = {"off": _stacked_grads(enc, view, mesh, x, 4)[1]}
    for policy in ("full", "dots"):
        cfg = dataclasses.replace(enc.cfg, remat=True, remat_policy=policy)
        res[policy] = _stacked_grads(enc, view, mesh, x, 4, encoder_layer_fn(cfg))[1]
    try:
        encoder_layer_fn(dataclasses.replace(enc.cfg, remat=True, remat_policy="x"))
        res["bad_policy"] = None
    except ValueError as e:
        res["bad_policy"] = str(e)
    return res


def case_pipeline_validation(p):
    enc = stacked_encoder(p)
    res = {}
    try:
        stack_to_stages(list(enc.layers), 3)
    except ValueError as e:
        res["stages"] = str(e)
    mesh = mesh_of(2, 4, 1)
    view = shard_encoder(enc, mesh)
    try:
        pipeline_apply(encoder_layer_fn(enc.cfg), view.layers,
                       batch_sharding(mesh, torch.from_numpy(p["x"])), mesh, n_micro=3)
    except ValueError as e:
        res["batch"] = str(e)
    try:
        view(torch.zeros(1, 1600))
    except ValueError as e:
        res["stage_forward"] = str(e)
    return res


def case_pipeline_tp(p):
    """dp x pp x tp (2, 2, 2): the forward and the gradients."""
    enc = stacked_encoder(p)
    x = torch.from_numpy(p["x"])
    mesh = mesh_of(2, 2, 2)
    view = shard_encoder(enc, mesh)
    with torch.no_grad():
        got = pipeline_apply(encoder_layer_fn(enc.cfg), view.layers, batch_sharding(mesh, x), mesh,
                             n_micro=2)
    res = {"fwd": np_(gather_batch(mesh, got))}
    res["gx"], res["g_layers"], res["coords"] = _stacked_grads(enc, view, mesh, x, 2)
    res["local_ffn_in"] = tuple(view.layers[0].ffn_in.weight.shape)
    return res


def case_pipelined_encoder(p):
    out = {}
    wav = torch.from_numpy(p["enc4_wav"])
    for output_layer in (9, 2):
        cfg = dataclasses.replace(tc.EmbedderConfig.tiny(), num_layers=4, scan_layers=True,
                                  output_layer=output_layer)
        enc = Wav2Vec2Encoder(cfg, torch.Generator().manual_seed(0), "cpu")
        load_encoder(enc, p["enc4_params"]["params"])
        mesh = mesh_of(4, 2, 1)
        view = shard_encoder(enc, mesh)
        with torch.no_grad():
            got = pipelined_encoder_apply(cfg, view, batch_sharding(mesh, wav), mesh, n_micro=2)
        out[output_layer] = np_(gather_batch(mesh, got))
    return out


def _explain(pipe, mesh, wav):
    from xai_audio_deepfakes_tpu_torch.parallel.inference import make_sharded_explain

    explain, _ = make_sharded_explain(pipe, mesh)
    out = explain(wav)
    return {k: np_(getattr(out, k)) for k in ("mask", "relevant_wav", "irrelevant_wav",
                                               "probs_clean", "probs_relevant",
                                               "probs_irrelevant")}


def case_sharded_explain(p):
    """make_sharded_explain on (4, 2, 1), (2, 2, 2) and (4, 1, 2), and its
    refusal of a stage axis without scan_layers."""
    pipe = _pipe(p, "tiny", scan_layers=True)
    res = {"pp": _explain(pipe, mesh_of(4, 2, 1), torch.from_numpy(p["wav8"])),
           "pp_tp": _explain(pipe, mesh_of(2, 2, 2), torch.from_numpy(p["wav4"])),
           "tp": _explain(pipe, mesh_of(4, 1, 2), torch.from_numpy(p["wav8"]))}
    from xai_audio_deepfakes_tpu_torch.parallel.inference import make_sharded_explain

    try:
        make_sharded_explain(_pipe(p, "tiny"), mesh_of(4, 2, 1))
    except ValueError as e:
        res["refusal"] = str(e)
    return res


# ---------------------------------------------------------------------------
# tests/test_train.py's tensor-parallel embedder; dryrun_multichip's sharded
# eval with a checkpoint
# ---------------------------------------------------------------------------


def case_tensor_parallel_embedder(p):
    pipe = _pipe(p, "tiny")
    mesh = mesh_of(4, 1, 2)
    view = shard_encoder(pipe.encoder, mesh)
    with torch.no_grad():
        got = view(torch.from_numpy(p["wav8"]))
    layer = view.layers[0]
    return {"feats": np_(got), "ffn_in": tuple(layer.ffn_in.weight.shape),
            "ffn_out": tuple(layer.ffn_out.weight.shape), "q": tuple(layer.q_proj.weight.shape),
            "nh": layer.nh, "whole_ffn_in": tuple(pipe.encoder.layers[0].ffn_in.weight.shape)}


def case_sharded_sweep_and_checkpoint(p):
    from xai_audio_deepfakes_tpu_torch.metrics.harness import run_explanation_metrics
    from xai_audio_deepfakes_tpu_torch.parallel.sharding import (
        embedder_param_specs,
        shard_params,
    )
    from xai_audio_deepfakes_tpu_torch.train.checkpoints import (
        load_sharded_checkpoint,
        save_sharded_checkpoint,
    )

    pipe = _pipe(p, "tiny")
    mesh = mesh_of(4, 1, 2)
    batches = [p["sweep0"], p["sweep1"]]
    res = {"sharded": run_explanation_metrics(pipe, batches, mesh=mesh),
           "local": run_explanation_metrics(pipe, batches)}
    tree = p["tiny"]["encoder"]
    specs = embedder_param_specs(tree, mesh.cfg)
    local = shard_params(tree, mesh, specs)
    local = _tree(lambda a: torch.from_numpy(np.ascontiguousarray(a)), local)
    path = save_sharded_checkpoint(p["ckpt_dir"], local, mesh, specs)
    back = load_sharded_checkpoint(path, local, mesh, specs)
    res["ckpt_equal"] = _tree_all(lambda a, b: a.shape == b.shape and torch.equal(a, b),
                                  back, local)
    res["ckpt_files"] = sorted(os.listdir(path))
    return res


def _tree(fn, tree):
    return {k: _tree(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _tree_all(fn, a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_all(fn, a[k], b[k]) for k in a)
    return bool(fn(a, b))


def case_mesh_errors(p):
    res = {}
    try:
        mesh_of(3, 1, 1)
    except ValueError as e:
        res["product"] = str(e)
    return res


# ---------------------------------------------------------------------------
# training: tests/test_train.py's mesh tests, dryrun_multichip's stages,
# BatchNorm over a group
# ---------------------------------------------------------------------------


def _train_step(p, mesh, **embedder):
    from xai_audio_deepfakes_tpu_torch.parallel.inference import shard_pipeline_params
    from xai_audio_deepfakes_tpu_torch.train.train_addvisor import (
        init_train_state,
        make_train_step,
    )
    from xai_audio_deepfakes_tpu_torch.convert import train_state_to_jax

    pipe = _pipe(p, "train_params", **embedder)
    view = shard_pipeline_params(pipe, mesh)
    state = init_train_state(view)
    _, aux = make_train_step(view, mesh=mesh)(state, p["train_wav"])
    mine = train_state_to_jax(state)
    return {"aux": {k: np_(aux[k]) for k in ("loss", "l_in", "l_out", "l1", "loss_vec")},
            "w_raw": mine["w_raw"], "unet_params": mine["unet_params"],
            "batch_stats": mine["unet_batch_stats"]}


def case_train_data_parallel(p):
    return _train_step(p, mesh_of(8, 1, 1))


def case_train_dp_tp(p):
    return _train_step(p, mesh_of(4, 1, 2))


def case_train_pp_tp(p):
    return _train_step(p, mesh_of(2, 2, 2), scan_layers=True)


def case_train_pipeline_epoch(p):
    """train_addvisor over one epoch on (4, 2, 1), and its refusal of a
    stage axis without scan_layers."""
    from xai_audio_deepfakes_tpu_torch.train.train_addvisor import train_addvisor

    pipe = _pipe(p, "train_params", scan_layers=True)
    records = []
    train_addvisor(pipe, lambda: [p["train_wav"]], num_epochs=1, log_fn=records.append,
                   mesh=mesh_of(4, 2, 1))
    res = {"loss": records[0]["loss"]}
    try:
        train_addvisor(_pipe(p, "train_params"), lambda: [p["train_wav"]], num_epochs=1,
                       mesh=mesh_of(4, 2, 1))
    except ValueError as e:
        res["refusal"] = str(e)
    return res


def case_batch_norm_group(p):
    """BatchNorm2d over a gloo group of 2 (ranks 0 and 1, each half of the
    batch): outputs and running statistics; the other ranks only join the
    group's creation."""
    from xai_audio_deepfakes_tpu_torch.models.unet import BatchNorm2d

    group = dist.new_group([0, 1])
    rank = dist.get_rank()
    if rank > 1:
        return None
    x = torch.from_numpy(p["bn_x"])
    half = x.shape[0] // 2
    bn = BatchNorm2d(x.shape[1], eps=1e-5, momentum=0.01).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["bn_scale"]))
        bn.bias.copy_(torch.from_numpy(p["bn_bias"]))
    bn.group = group
    local = x[rank * half:(rank + 1) * half].clone().requires_grad_(True)
    y = bn(local)
    (y ** 3).sum().backward()
    return {"y": np_(y), "mean": np_(bn.running_mean), "var": np_(bn.running_var),
            "gx": np_(local.grad), "gw": np_(bn.weight.grad), "gb": np_(bn.bias.grad)}


# ---------------------------------------------------------------------------
# the CLI's mesh flags on every rank
# ---------------------------------------------------------------------------


def _cli_on_tiny(p):
    """The port's CLI over a tiny pipeline with the payload's weights (every
    rank the same), its closed loop cut to that geometry, the detector fit
    to 20 L-BFGS steps: tests/test_torch_cli.py's `port_only`."""
    import functools

    from xai_audio_deepfakes_tpu_torch.cli import __main__ as cli
    from xai_audio_deepfakes_tpu_torch.train import closed_loop, train_logreg

    os.environ["ADDVISOR_DEVICE"] = "cpu"
    cfg = tiny(scan_layers=True)

    def build(args):
        pipe = ADDvisorPipeline(cfg, device="cpu", seed=9)
        load_jax_params(pipe, p["train_params"])
        return pipe

    cli._build_pipeline = build
    if not isinstance(train_logreg.fit_logreg, functools.partial):
        train_logreg.fit_logreg = functools.partial(train_logreg.fit_logreg, max_iter=20)
        loop = closed_loop.run_closed_loop
        closed_loop.run_closed_loop = lambda c, **kw: loop(
            cfg.replace(train=c.train, loss=c.loss), **kw)
    return cli


def _cli_json(cli, argv) -> dict | None:
    import contextlib
    import io
    import json

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    lines = buf.getvalue().strip().splitlines()
    return json.loads(lines[-1]) if lines else None


def case_cli_jobs(p):
    """eval --model-parallel 2, train --data-parallel 4 --model-parallel 2
    and closed-loop --pipeline-stages 2 --scan-layers on the world of 8,
    each beside the same job without a mesh flag (rank 0's output; the
    trained decoders from each run's checkpoint)."""
    cli = _cli_on_tiny(p)
    meta, root, out = p["cli_meta"], p["cli_root"], p["cli_out"]
    rank = dist.get_rank()
    res = {}
    ev = ["eval", "--metadata", meta, "--root", root, "--batch-size", "8"]
    res["eval"] = (_cli_json(cli, ev + ["--model-parallel", "2"]), _cli_json(cli, ev))
    for name, flags in (("mesh", ["--data-parallel", "4", "--model-parallel", "2"]),
                        ("plain", [])):
        d = os.path.join(out, f"train_{name}" if flags else f"train_plain_{rank}")
        res[f"train_{name}"] = _cli_json(cli, ["train", "--metadata", meta, "--root", root,
                                               "--batch-size", "8", "--epochs", "1", "--out", d]
                                         + flags)
        ckpt = os.path.join(d, "ckpts")
        from xai_audio_deepfakes_tpu_torch.train.checkpoints import latest_checkpoint, load_checkpoint

        path = latest_checkpoint(ckpt) if rank == 0 or not flags else None
        res[f"decoder_{name}"] = (None if path is None else
                                  {k: np_(v) for k, v in load_checkpoint(path)["decoder"].items()})
    cl = ["closed-loop", "--n-train", "8", "--n-eval", "4", "--epochs", "1", "--batch-size", "8",
          "--artifact-limit", "0"]
    res["closed_loop"] = (
        _cli_json(cli, cl + ["--pipeline-stages", "2", "--scan-layers", "--out",
                             os.path.join(out, "cl_mesh")]),
        _cli_json(cli, cl + ["--scan-layers", "--out", os.path.join(out, f"cl_plain_{rank}")]))
    return res


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def world_of_one():
    """A gloo world of this process alone for the block (the default
    group, on a free localhost port)."""
    initialize_distributed("cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, world: int, port: int, payload_path: str, out_dir: str,
               cases: list) -> None:
    torch.set_num_threads(1)
    initialize_distributed("cpu", f"tcp://localhost:{port}", world, rank)
    with open(payload_path, "rb") as f:
        payload = pickle.load(f)
    results = {}
    for name in cases:
        try:
            results[name] = ("ok", globals()[f"case_{name}"](payload))
        except Exception:  # carried to the parent, which fails the test that reads it
            results[name] = ("error", traceback.format_exc())
        dist.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


def run_world(world: int, payload: dict, cases: list, tmp: str) -> list:
    """Spawn `world` processes that run `cases` in order on one gloo group
    -> each rank's {case: ("ok", result) or ("error", traceback)}."""
    import torch.multiprocessing as mp

    payload_path = os.path.join(tmp, "payload.pkl")
    with open(payload_path, "wb") as f:
        pickle.dump(payload, f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(_rank_main, args=(world, port, payload_path, tmp, cases), nprocs=world,
                       join=True, start_method="spawn")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
