"""PyTorch port: the kernels as registered ops (`torch.library.opcheck` on
CPU inputs, the CPU implementation equal to the plain version bit for bit)
and the serving artifact (`serve/export.py`) on the CPU at tiny geometry:
the flatten round trip, the files, the artifact against the port's eager
explain (bit for bit) and against the JAX package's `load_exported`
artifact (mask 1e-5, waveforms 2e-4, probabilities 1e-4), the fixed shape,
the weight hot swap, serving from the artifact, the graph's kernel ops and
a loader that imports no model code. One export of each package, shared by
the module."""

import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.library import opcheck

from xai_audio_deepfakes_tpu import config as jc
from xai_audio_deepfakes_tpu.pipeline.core import ADDvisorPipeline as JPipeline
from xai_audio_deepfakes_tpu.serve import export as jexport
from tests.test_torch_models import random_params
from tests.test_torch_pipeline import _tiny, jax_params  # noqa: F401 (a fixture)
from xai_audio_deepfakes_tpu_torch import config as tc
from xai_audio_deepfakes_tpu_torch.config import STFTConfig
from xai_audio_deepfakes_tpu_torch.convert import load_jax_params
from xai_audio_deepfakes_tpu_torch.ops import (
    attention,
    cuda_conv,
    cuda_ln_gelu,
    cuda_pos_conv,
    cuda_stft,
)
from xai_audio_deepfakes_tpu_torch.ops.stft import istft_plain, stft_plain
from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline
from xai_audio_deepfakes_tpu_torch.serve import export
from xai_audio_deepfakes_tpu_torch.serve.api import start_api_server
from xai_audio_deepfakes_tpu_torch.serve.export import OUTPUT_FIELDS

ROOT = Path(__file__).resolve().parent.parent
BATCH = 2
# the slice bars of the port against the JAX package
BARS = {"mask": 1e-5, "magnitude": 1e-4, "phase": None, "relevant_wav": 2e-4,
        "irrelevant_wav": 2e-4, "probs_clean": 1e-4, "probs_relevant": 1e-4,
        "probs_irrelevant": 1e-4}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny CPU work beside the suite's other workers: one intra-op thread
    (several threads per worker oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the registered ops
# ---------------------------------------------------------------------------


def _op_cases():
    """(op, args, plain version of the same call) for each registered op, at
    small shapes; seeded inputs."""
    g = torch.Generator().manual_seed(0)
    cfg = STFTConfig()
    args = cuda_stft._cfg_args(cfg)
    x = torch.randn(2, 4000, generator=g) * 0.1
    re, im = stft_plain(x, cfg)
    q, k, v = (torch.randn(2, 17, 256, generator=g).bfloat16() for _ in range(3))
    y = (torch.randn(2, 128, 33, generator=g) * 2 + 0.5).bfloat16()
    scale, bias = 1 + 0.1 * torch.randn(128, generator=g), 0.1 * torch.randn(128, generator=g)
    w = (torch.randn(128, 128, 3, generator=g) * 0.05).bfloat16()
    cb = 0.1 * torch.randn(128, generator=g)
    xp = torch.randn(2, 19, 48, generator=g).bfloat16()
    wp = (torch.randn(48, 24, 5, generator=g) * 0.1).bfloat16()
    bp = (0.1 * torch.randn(48, generator=g)).bfloat16()
    pimg, gimg = cuda_pos_conv.pos_conv_image(wp), cuda_pos_conv.pos_conv_grad_image(wp)
    return {
        "attention": (attention.attention_op, (q, k, v, 2),
                      lambda: attention.attention_plain(q, k, v, 2)),
        "stft": (cuda_stft.stft_op, (x, *args), lambda: stft_plain(x, cfg)),
        "istft": (cuda_stft.istft_op, (re, im, *args, 4000),
                  lambda: istft_plain(re, im, cfg, 4000)),
        "istft_batch_1": (cuda_stft.istft_op, (re[:1], im[:1], *args, 4000),
                          lambda: istft_plain(re[:1], im[:1], cfg, 4000)),
        "ln_gelu": (cuda_ln_gelu.ln_gelu_op, (y, scale, bias, 1e-5, "exact"),
                    lambda: cuda_ln_gelu.ln_gelu_plain(y, scale, bias, 1e-5, "exact")),
        "ln_gelu_": (cuda_ln_gelu.ln_gelu_inplace_op, (y.clone(), scale, bias, 1e-5, "tanh"),
                     lambda: cuda_ln_gelu.ln_gelu_plain(y, scale, bias, 1e-5, "tanh")),
        "conv_ln_gelu": (cuda_conv.conv_ln_gelu_op, (y, w, cb, scale, bias, 1e-5, "exact"),
                         lambda: cuda_conv.conv_ln_gelu_plain(y, w, cb, scale, bias, 1e-5,
                                                              "exact")),
        "pos_conv": (cuda_pos_conv.pos_conv_op, (xp, pimg, bp, 5, 2, 19),
                     lambda: cuda_pos_conv.pos_conv_plain(xp, wp, bp, 2, 19)),
        "pos_conv_dgrad": (cuda_pos_conv.pos_conv_dgrad_op, (xp, gimg, 5, 2),
                           lambda: cuda_pos_conv.pos_conv_plain(
                               xp, cuda_pos_conv.grad_weight(wp), None, 2, 19)),
    }


@pytest.mark.parametrize("name", list(_op_cases()))
def test_registered_op_passes_opcheck_and_equals_plain(name):
    """opcheck (schema, autograd registration, fake implementation against
    the real one, AOT dispatch) on CPU inputs; the op's CPU implementation
    equals the plain version bit for bit."""
    op, args, plain = _op_cases()[name]
    assert set(opcheck(op, args).values()) == {"SUCCESS"}
    got = op(*args)
    if got is None:  # the in-place op writes into its first argument
        got = args[0]
    want = plain()
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipe(jax_params):
    p = ADDvisorPipeline(_tiny(tc), device="cpu", seed=9)
    load_jax_params(p, jax_params)
    return p


@pytest.fixture(scope="module")
def wav():
    return (np.random.default_rng(5).standard_normal((BATCH, 8000)) * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def art_dir(pipe, tmp_path_factory):
    out = tmp_path_factory.mktemp("artifact") / "art"
    export.save_exported(str(out), pipe, BATCH)
    return out


@pytest.fixture(scope="module")
def art(art_dir):
    return export.load_exported(str(art_dir))


@pytest.fixture(scope="module")
def jax_art(jax_params, tmp_path_factory):
    """The JAX package's artifact of the same pipeline, weights and batch."""
    out = tmp_path_factory.mktemp("jax_artifact")
    params = jax.tree.map(jnp.asarray, jax_params)
    jexport.save_exported(str(out), JPipeline(_tiny(jc)), params, BATCH)
    return jexport.load_exported(str(out))


def test_flatten_round_trip(pipe):
    """explain_params -> flatten -> unflatten gives the tree back, the same
    tensors; the keys are the JAX package's flatten of the same nesting; a
    key holding '/' raises."""
    tree = export.explain_params(pipe)
    assert set(tree) == {"encoder", "unet", "logreg"}
    flat = export.flatten_params(tree)
    assert all(isinstance(v, torch.Tensor) for v in flat.values())
    as_numpy = jax.tree.map(lambda t: t.detach().numpy(), tree)
    assert set(flat) == set(jexport.flatten_params(as_numpy))
    back = export.unflatten_params(flat)
    assert export.flatten_params(back).keys() == flat.keys()
    assert all(export.flatten_params(back)[k] is v for k, v in flat.items())
    with pytest.raises(ValueError, match="contains '/'"):
        export.flatten_params({"a/b": np.zeros(1)})


def test_artifact_files_and_meta(art_dir, pipe):
    """The three files; meta.json's contract fields; params.npz holds every
    weight of the graph, each dtype recorded."""
    assert sorted(p.name for p in art_dir.iterdir()) == ["explain.pt2", "meta.json",
                                                         "params.npz"]
    meta = json.loads((art_dir / "meta.json").read_text())
    assert {k: meta[k] for k in ("batch_size", "num_samples", "sample_rate", "decoder",
                                 "masking", "device")} == {
        "batch_size": BATCH, "num_samples": 8000, "sample_rate": 16000, "decoder": "unet",
        "masking": "log1p", "device": "cpu"}
    assert meta["torch_version"] == torch.__version__
    with np.load(art_dir / "params.npz") as z:
        assert set(z.files) == set(meta["param_dtypes"])
        flat = export.flatten_params(export.explain_params(pipe))
        for k, v in flat.items():
            np.testing.assert_array_equal(z[k], v.detach().numpy(), err_msg=k)
    assert (art_dir / "explain.pt2").stat().st_size < 2 * (art_dir / "params.npz").stat().st_size


def test_artifact_matches_eager_explain(art, pipe, wav):
    """The same ops in the same order: bit-equal to the eager explain (bar
    1e-6); ExplainOutput's field names."""
    got = art(wav)
    want = pipe.explain(wav)
    assert got._fields == type(want)._fields
    for f in got._fields:
        torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=0, atol=1e-6,
                                   msg=f)
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_artifact_matches_jax_artifact(art, jax_art, wav):
    """The port's artifact against the JAX package's at the slice bars."""
    got, want = art(wav), jax_art(wav)
    for f, bar in BARS.items():
        if bar is None:  # the phase of near-zero bins is ill-conditioned
            continue
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=bar, err_msg=f)


def test_artifact_is_fixed_shape(art, wav):
    for bad in (wav[:1], np.zeros((BATCH, 8001), np.float32)):
        with pytest.raises(ValueError, match="fixed-shape"):
            art(bad)


def test_with_params_swaps_the_weights(art, jax_params, wav):
    """A second UNet's weights through `with_params` match an eager
    pipeline holding them; the artifact itself keeps its own."""
    mag = jnp.zeros((1, 64, 24), jnp.float32)
    unet2 = random_params(JPipeline(_tiny(jc)).unet.init, jax.random.PRNGKey(0), mag, seed=12)
    other = ADDvisorPipeline(_tiny(tc), device="cpu", seed=9)
    load_jax_params(other, {**jax_params, "unet": unet2})
    swapped = art.with_params(export.explain_params(other))
    for f in ("mask", "relevant_wav", "probs_irrelevant"):
        torch.testing.assert_close(getattr(swapped(wav), f), getattr(other.explain(wav), f),
                                   rtol=0, atol=1e-6)
    assert not torch.equal(swapped(wav).mask, art(wav).mask)
    with pytest.raises(ValueError, match="do not match the graph"):
        art.with_params({"unet": export.explain_params(other)["unet"]})


def test_serve_api_from_the_artifact(art, wav):
    """The HTTP service with the artifact as its pipeline and explain: a
    request answered as the artifact answers it directly."""
    import http.client

    from xai_audio_deepfakes_tpu_torch.data.io import load_audio_bytes, wav_to_bytes

    server, service = start_api_server(art, port=0, batch_size=art.batch_size,
                                       decoder=art.decoder, explain_fn=art)
    try:
        body = wav_to_bytes(wav[0])
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
        conn.request("POST", "/explain?audio=0", body=body)
        resp = conn.getresponse()
        got = json.loads(resp.read())
        conn.close()
        assert resp.status == 200
        clip = load_audio_bytes(body, clip_seconds=0.5)[0]
        want = art(np.stack([clip, np.zeros_like(clip)]))
        assert got["pred_original"] == pytest.approx(float(want.probs_clean[0, 0]), abs=1e-6)
        assert got["mask_mean"] == pytest.approx(float(want.mask[0].mean()), abs=1e-6)
        assert service.stats["requests"] == 1
    finally:
        server.shutdown()
        server.server_close()
        service.stop()


def test_loader_registers_every_kernel_op():
    """In a process that imports no model code, the loader's registration
    resolves every kernel op a graph may call: each `LAUNCHES` key is an
    `addv::` op (a cuda graph of the bf16 embedder calls `addv::pos_conv`,
    which the CPU graphs here never hold)."""
    code = ("import torch\n"
            "from xai_audio_deepfakes_tpu_torch.serve.export import register_kernel_ops\n"
            "from xai_audio_deepfakes_tpu_torch.ops._cuda import LAUNCHES\n"
            "register_kernel_ops()\n"
            "for name in LAUNCHES:\n"
            "    getattr(torch.ops.addv, name).default\n"
            "print(sorted(LAUNCHES))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "pos_conv_dgrad" in r.stdout


def test_graph_holds_the_kernel_ops(art, pipe):
    """Kernel A once per layer, B once, C twice, each as its `addv` op; no
    weight and no constant in the program."""
    counts: dict = {}
    for node in art._program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("addv."):
            counts[str(node.target)] = counts.get(str(node.target), 0) + 1
    layers = len(pipe.encoder.layers)
    assert counts == {"addv.attention.default": layers, "addv.stft.default": 1,
                      "addv.istft.default": 2}
    assert not art._program.state_dict and not art._program.constants


def test_artifact_runs_without_model_code(art_dir, art, wav, tmp_path):
    """A second process loads and runs the artifact with the port's
    `models` and `pipeline` blocked: the same outputs, no model module
    imported."""
    np.save(tmp_path / "wav.npy", wav)
    np.save(tmp_path / "want.npy", art(wav).relevant_wav.numpy())
    code = (
        "import sys\n"
        "for m in ('xai_audio_deepfakes_tpu_torch.models',\n"
        "          'xai_audio_deepfakes_tpu_torch.pipeline', 'jax', 'xai_audio_deepfakes_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from xai_audio_deepfakes_tpu_torch.serve.export import load_exported\n"
        f"art = load_exported({str(art_dir)!r})\n"
        f"out = art(np.load({str(tmp_path / 'wav.npy')!r}))\n"
        f"err = np.abs(out.relevant_wav.numpy() - np.load({str(tmp_path / 'want.npy')!r})).max()\n"
        "assert err <= 1e-6, err  # one intra-op thread here: another summation order\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and m.startswith(\n"
        "    ('xai_audio_deepfakes_tpu_torch.models', 'xai_audio_deepfakes_tpu_torch.pipeline'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_artifact_runs_only_on_its_device(art_dir, tmp_path):
    """A CPU artifact refuses another device; a CUDA artifact without CUDA
    raises (no artifact falls back from one device to the other)."""
    with pytest.raises(ValueError, match="exported for cpu"):
        export.load_exported(str(art_dir), device="cuda")
    if torch.cuda.is_available():
        pytest.skip("a card is present: a CUDA artifact would load")
    cuda_dir = tmp_path / "cuda_art"
    shutil.copytree(art_dir, cuda_dir)
    meta = json.loads((cuda_dir / "meta.json").read_text())
    (cuda_dir / "meta.json").write_text(json.dumps({**meta, "device": "cuda"}))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.load_exported(str(cuda_dir))


# ---------------------------------------------------------------------------
# several platforms (`export --platforms`)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cpu_platform_dir(pipe, tmp_path_factory):
    out = tmp_path_factory.mktemp("platforms") / "art"
    export.save_exported(str(out), pipe, BATCH, platforms=("cpu",))
    return out


def test_platforms_cpu_writes_todays_artifact(cpu_platform_dir, art_dir):
    """platforms=("cpu",) writes the same three files as the default, and
    meta.json lists the platforms, as the JAX package's does; so does the
    default's."""
    assert sorted(p.name for p in cpu_platform_dir.iterdir()) == ["explain.pt2", "meta.json",
                                                                  "params.npz"]
    meta = json.loads((cpu_platform_dir / "meta.json").read_text())
    assert meta["platforms"] == ["cpu"] and meta["device"] == "cpu"
    assert json.loads((art_dir / "meta.json").read_text())["platforms"] == ["cpu"]


def test_cpu_graph_matches_jax_artifact(cpu_platform_dir, jax_art, wav):
    """The CPU graph loaded by name against the JAX package's artifact at
    the slice bars."""
    art = export.load_exported(str(cpu_platform_dir), device="cpu")
    assert art.device == torch.device("cpu")
    got, want = art(wav), jax_art(wav)
    for f, bar in BARS.items():
        if bar is not None:
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       atol=bar, err_msg=f)


def test_platforms_cuda_without_a_card_raises_and_writes_nothing(pipe, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda graph would be traced")
    out = tmp_path / "art"
    with pytest.raises(ValueError, match="CUDA is not available here.*--platforms cpu"):
        export.save_exported(str(out), pipe, BATCH, platforms=("cuda", "cpu"))
    assert not out.exists()
    with pytest.raises(ValueError, match="unknown platforms"):
        export.save_exported(str(out), pipe, BATCH, platforms=("tpu",))


def test_pipeline_on_another_device_holds_the_same_weights(pipe, wav):
    """The pipeline a graph of another device is traced on: the same
    configuration and weights (from a pipeline that names another device
    but holds CPU tensors, so that the test needs no card), hence the same
    explain bit for bit; on the pipeline's own device, the pipeline."""
    assert export.pipeline_on(pipe, "cpu") is pipe
    named = types.SimpleNamespace(**{k: getattr(pipe, k) for k in (
        "cfg", "encoder", "unet", "feat_decoder", "logreg", "quant_scales")},
        device=torch.device("cuda"))
    twin = export.pipeline_on(named, "cpu")
    assert twin is not pipe and twin.device == torch.device("cpu")
    for f, a, b in zip(OUTPUT_FIELDS, twin.explain(wav), pipe.explain(wav)):
        assert torch.equal(a, b), f


def test_cli_export_platforms_reaches_save_exported(pipe, tmp_path, monkeypatch):
    """`export --platforms cuda,cpu` hands ("cuda", "cpu") to save_exported;
    without a card it raises there and writes nothing."""
    from xai_audio_deepfakes_tpu_torch.cli import __main__ as cli

    monkeypatch.setattr(cli, "_build_pipeline", lambda args: pipe)
    seen: list = []
    real = export.save_exported

    def spy(*a, **kw):
        seen.append(kw["platforms"])
        return real(*a, **kw)

    monkeypatch.setattr(export, "save_exported", spy)
    out = tmp_path / "art"
    argv = ["--device", "cpu", "export", "--batch-size", str(BATCH), "--out", str(out)]
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA is not available"):
            cli.main(argv + ["--platforms", "cuda,cpu"])
        assert seen == [("cuda", "cpu")] and not out.exists()
    monkeypatch.setattr(export, "export_explain", lambda *a, **k: pytest.fail("traced"))
    with pytest.raises(ValueError, match="unknown platforms"):
        cli.main(argv + ["--platforms", "cpu,tpu"])
    assert seen[-1] == ("cpu", "tpu")
