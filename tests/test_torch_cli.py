"""PyTorch port: the command line (`cli/__main__.py`) against the JAX
package's on the CPU at tiny geometry. The two parsers, subcommand by
subcommand (every option's dest, default and choices; the deliberate
differences listed in DIFFERENCES); `explain`, `eval`, `embed` and
`train-detector` through both CLIs with `_build_pipeline` replaced by the
twin tiny pipelines (same weights), held at the slice bars (mask 1e-5,
waveforms 2e-4, probabilities 1e-4) and `train-detector` at the fit's bars
(accuracy equal, EER 1e-6); every other subcommand as wiring; the
refusals, the mesh flags in a world of one, the device rule and the
missing-matplotlib path."""

import argparse
import dataclasses
import json
import sys
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_audio_deepfakes_tpu import config as jc
from xai_audio_deepfakes_tpu.cli import __main__ as jcli
from xai_audio_deepfakes_tpu.pipeline.core import ADDvisorPipeline as JPipeline
from tests.test_torch_pipeline import _tiny, jax_params  # noqa: F401 (a fixture)
from xai_audio_deepfakes_tpu_torch import config as tc
from xai_audio_deepfakes_tpu_torch.cli import __main__ as cli
from xai_audio_deepfakes_tpu_torch.convert import load_jax_params
from xai_audio_deepfakes_tpu_torch.data.io import read_wav, write_wav
from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline
from xai_audio_deepfakes_tpu_torch.train import artifacts

# the port's deliberate differences from the JAX parser: (subcommand or
# "" for the global options, dest) -> what the port has instead
DIFFERENCES = {
    ("", "platform"): "--device {cuda,cpu}: where the pipeline runs, never a fallback",
    ("", "device"): "(the port's, in place of --platform)",
}
NAMES = ("a.wav", "b.wav", "c.wav", "d.wav")



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny CPU work beside the suite's other workers: one intra-op thread
    (several threads per worker oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

class _Captured(Exception):
    def __init__(self, parser):
        self.parser = parser


def _jax_parser() -> argparse.ArgumentParser:
    """The JAX CLI's parser, caught at its parse_args (nothing runs)."""

    def capture(self, args=None, namespace=None):
        raise _Captured(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Captured) as caught:
            jcli.main(["explain", "--wav", "x.wav"])
    return caught.value.parser


def _options(parser: argparse.ArgumentParser) -> dict:
    """{(subcommand, dest): (default, choices)} of a two-level parser."""
    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out.update({(name, k[1]): v for k, v in _options(sub).items()})
        elif not isinstance(action, argparse._HelpAction):
            out[("", action.dest)] = (action.default, action.choices)
    return out


def test_parsers_match_jax():
    """Every option of every subcommand: the same dest, default and
    choices as the JAX CLI's, but for DIFFERENCES."""
    mine, theirs = _options(cli.build_parser()), _options(_jax_parser())
    assert {k for k in mine if k[0]} | {k for k in theirs if k[0]}  # subcommands seen
    assert {k[0] for k in mine} == {k[0] for k in theirs}
    differ = {k for k in set(mine) | set(theirs) if mine.get(k) != theirs.get(k)}
    # the JAX --platform default is read from the environment: compare names only
    assert differ == set(DIFFERENCES), sorted(differ ^ set(DIFFERENCES))
    assert mine[("", "device")][1] == ["cuda", "cpu"]


# ---------------------------------------------------------------------------
# through both CLIs, with the twin tiny pipelines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four 0.5 s clips as 16-bit wavs and a metadata file naming them."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(6)
    for name in NAMES:
        write_wav(str(root / name), rng.uniform(-0.3, 0.3, 8000), 16000)
    (root / "meta.csv").write_text("".join(f"{n},bonafide\n" for n in NAMES))
    return root


@pytest.fixture(scope="module")
def twins(jax_params):
    """The JAX pipeline with its weights, the port's with the same ones, and
    a cache that lets the JAX CLI's commands share one compiled explain."""
    jpipe = JPipeline(_tiny(jc))
    compiled: dict = {}
    jit_explain = jpipe.jit_explain

    def cached(decoder="unet", masking=None):
        key = (decoder, masking)
        if key not in compiled:
            compiled[key] = jit_explain(decoder, masking)
        return compiled[key]

    object.__setattr__(jpipe, "jit_explain", cached)
    params = jax.tree.map(jnp.asarray, jax_params)
    pipe = ADDvisorPipeline(_tiny(tc), device="cpu", seed=9)
    load_jax_params(pipe, jax_params)
    return jpipe, params, pipe


def _run(main, argv, capsys) -> dict:
    """main(argv); its last stdout line as JSON."""
    capsys.readouterr()
    rc = main(argv)
    assert rc in (None, 0)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def both(twins, monkeypatch):
    """Both CLIs with `_build_pipeline` returning the twins; PNG writers
    replaced by no-ops in both packages (the files are not compared)."""
    jpipe, params, pipe = twins
    monkeypatch.setattr(jcli, "_build_pipeline", lambda args: (jpipe, params))
    monkeypatch.setattr(cli, "_build_pipeline", lambda args: pipe)
    from xai_audio_deepfakes_tpu.train import artifacts as jartifacts

    for mod in (jartifacts, artifacts):
        for name in ("save_mask_png", "save_spectrogram_png", "save_features_png"):
            monkeypatch.setattr(mod, name, lambda *a, **k: None)
    return twins


@pytest.mark.parametrize("cmd", ["explain", "eval", "embed"])
def test_command_matches_jax_cli(cmd, both, corpus, tmp_path, capsys):
    """The same command line through both CLIs (`--device cpu` for the
    port): the same JSON keys and files, the numbers at the slice bars."""
    common = ["--batch-size", "2", "--out"]
    argv = {
        "explain": ["explain", "--chunk-long", "--wav", *(str(corpus / n) for n in NAMES[:2])],
        "eval": ["eval", "--metadata", str(corpus / "meta.csv"), "--root", str(corpus)],
        "embed": ["embed", "--metadata", str(corpus / "meta.csv"), "--root", str(corpus)],
    }[cmd]
    want = _run(jcli.main, argv + common + [str(tmp_path / "jax")], capsys)
    got = _run(cli.main, ["--device", "cpu"] + argv + common + [str(tmp_path / "port")], capsys)
    assert got.keys() == want.keys()
    if cmd == "explain":
        assert got["explained"] == want["explained"] == 2
        r_got, r_want = (json.loads((tmp_path / d / "results.json").read_text())
                         for d in ("port", "jax"))
        for a, b in zip(r_got, r_want):
            assert a.keys() == b.keys()
            for k in ("pred_original", "pred_reconstructed_mask", "pred_reconstructed_1mask"):
                assert a[k] == pytest.approx(b[k], abs=1e-4), k
        for n in NAMES[:2]:
            stem = n[:-4]
            a, b = (read_wav(str(tmp_path / d / f"{stem}_explanation.wav"))[0]
                    for d in ("port", "jax"))
            np.testing.assert_allclose(a, b, atol=2e-4 + 1 / 32768)
    elif cmd == "eval":
        assert got["num_clips"] == want["num_clips"] == 4
        for k, v in want.items():
            assert got[k] == pytest.approx(v, abs=1e-4, rel=1e-4), k
    else:
        assert got == want == {"embedded": 4, "dim": 32}
        a, b = (np.load(tmp_path / d / "embeddings.npz") for d in ("port", "jax"))
        np.testing.assert_allclose(a["features"], b["features"], atol=1e-4)
        np.testing.assert_allclose(a["probs"], b["probs"], atol=1e-4)
        assert list(a["paths"]) == list(b["paths"]) == list(NAMES)


def test_train_detector_matches_jax_cli(tmp_path, capsys):
    """train-detector through both CLIs on one features file: accuracy
    equal, EER within 1e-6; the head written where `--logreg-joblib`
    reads it."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((200, 6)).astype(np.float32)
    y = (x @ rng.standard_normal(6) + 0.5 * rng.standard_normal(200) > 0).astype(np.int64)
    np.savez(tmp_path / "fx.npz", X=x, y=y)
    want = _run(jcli.main, ["train-detector", "--features", str(tmp_path / "fx.npz"),
                            "--out", str(tmp_path / "jax")], capsys)
    got = _run(cli.main, ["--device", "cpu", "train-detector", "--features",
                          str(tmp_path / "fx.npz"), "--out", str(tmp_path / "port")], capsys)
    assert got["accuracy"] == want["accuracy"]
    assert abs(got["eer"] - want["eer"]) <= 1e-6
    assert (tmp_path / "port" / "logreg_vocoded_anyband.npz").is_file()


# ---------------------------------------------------------------------------
# the other subcommands, as wiring (the port's CLI only)
# ---------------------------------------------------------------------------


def _wiring_config():
    """A tiny pipeline whose embedder keeps XLS-R's conv strides (a 5 s clip,
    which `datagen` reads whatever the pipeline's contract, gives 249
    frames, not 4000), over the tiny UNet and a small HiFi-GAN."""
    emb = dataclasses.replace(tc.EmbedderConfig.tiny(), conv_dim=(8,) * 7,
                              conv_kernel=(10, 3, 3, 3, 3, 2, 2), conv_stride=(5, 2, 2, 2, 2, 2, 2),
                              num_layers=1, output_layer=1)
    return _tiny(tc).replace(embedder=emb, hifigan=tc.HiFiGANConfig(upsample_initial_channel=16))


@pytest.fixture
def port_only(monkeypatch):
    """The port's CLI over `_wiring_config`'s pipeline on the CPU; its
    closed loop cut to that geometry and its detector fit to 20 L-BFGS
    steps (the fit is held against JAX's in tests/test_torch_detector.py)."""
    import functools

    from xai_audio_deepfakes_tpu_torch.train import closed_loop, train_logreg

    pipe = ADDvisorPipeline(_wiring_config(), device="cpu", seed=9)
    monkeypatch.setenv("ADDVISOR_DEVICE", "cpu")
    monkeypatch.setattr(cli, "_build_pipeline", lambda args: pipe)
    monkeypatch.setattr(train_logreg, "fit_logreg",
                        functools.partial(train_logreg.fit_logreg, max_iter=20))

    loop = closed_loop.run_closed_loop

    def tiny_loop(cfg, **kw):
        return loop(_wiring_config().replace(train=cfg.train, loss=cfg.loss), **kw)

    monkeypatch.setattr(closed_loop, "run_closed_loop", tiny_loop)
    return pipe


def test_wiring_of_the_data_commands(port_only, corpus, tmp_path, capsys):
    """datagen, vocode-datagen and attrib with artifacts: JSON lines and
    files (train-detector runs in `test_train_detector_matches_jax_cli`)."""
    meta, root = str(corpus / "meta.csv"), str(corpus)
    res = _run(cli.main, ["datagen", "--metadata", meta, "--root", root, "--vocoded-root",
                          root, "--limit", "1", "--out", str(tmp_path / "dg")], capsys)
    assert res == {"X_shape": [9, 32], "labels": 8}
    with np.load(tmp_path / "dg" / "band_swap_features.npz") as z:
        assert z["X"].shape == (9, 32) and list(z["y"]) == [0] + [1] * 8
    res = _run(cli.main, ["vocode-datagen", "--metadata", meta, "--root", root, "--limit", "1",
                          "--out", str(tmp_path / "voc")], capsys)
    assert res == {"written": 8} and len(list((tmp_path / "voc").rglob("*.wav"))) == 8
    res = _run(cli.main, ["attrib", "--metadata", meta, "--root", root, "--limit", "1",
                          "--batch-size", "1", "--save-artifacts", "--out",
                          str(tmp_path / "attrib")], capsys)
    assert res["num_clips"] == 1 and res["artifacts"] == 1
    assert (tmp_path / "attrib" / "a_input_x_gradient_relevant.wav").is_file()
    assert (tmp_path / "attrib" / "a_input_x_gradient_wavmask.png").is_file()


def test_wiring_of_the_training_commands(port_only, corpus, tmp_path, capsys):
    """train, then train --resume from its checkpoint (the step count goes
    on), and closed-loop with its checkpoint, JSON and gallery."""
    train = ["train", "--metadata", str(corpus / "meta.csv"), "--root", str(corpus),
             "--batch-size", "2", "--epochs", "1", "--out", str(tmp_path / "train")]
    assert _run(cli.main, train, capsys) == {"trained_steps": 2}
    assert _run(cli.main, train + ["--resume"], capsys) == {"trained_steps": 4}
    assert any((tmp_path / "train" / "ckpts").iterdir())
    assert (tmp_path / "train" / "1_explanation.png").is_file()
    res = _run(cli.main, ["closed-loop", "--n-train", "4", "--n-eval", "2", "--epochs", "1",
                          "--batch-size", "2", "--out", str(tmp_path / "cl")], capsys)
    assert len(res["train_log"]) == 1 and "detector" in res
    for name in ("closed_loop.json", "index.html", "eval_0_relevant.wav"):
        assert (tmp_path / "cl" / name).is_file(), name
    assert any((tmp_path / "cl" / "ckpts").iterdir())


def test_wiring_of_export_serve_api_and_profile(port_only, corpus, tmp_path, capsys):
    """export, then serve-api --exported answering a request on a thread;
    profile with a trace that holds the `addv` ops."""
    res = _run(cli.main, ["export", "--batch-size", "2", "--out", str(tmp_path / "art")],
               capsys)
    assert res["device"] == "cpu" and set(res["files"]) == {"explain.pt2", "params.npz",
                                                             "meta.json"}
    port = _serve_on_thread(["serve-api", "--exported", str(tmp_path / "art"), "--port", "0"])
    with urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/explain?audio=0", data=(corpus / NAMES[0]).read_bytes()),
            timeout=60) as r:
        got = json.loads(r.read())
    assert 0 < got["pred_original"] < 1 and "relevant_wav_b64" not in got
    res = _run(cli.main, ["profile", "--batch-size", "2", "--iters", "1", "--trace-dir",
                          str(tmp_path / "trace")], capsys)
    assert res["device"] == "cpu" and res["explain_full"]["calls"] == 1
    trace = (tmp_path / "trace" / "trace.json").read_text()
    assert "addv::attention" in trace and "addv::istft" in trace


def _serve_on_thread(argv) -> int:
    """Run a serving subcommand on a daemon thread with port 0 and return
    the port it bound (read from the server the service module built)."""
    from xai_audio_deepfakes_tpu_torch.serve import api

    bound: list = []
    server_of = api._server

    def recording(*a, **k):
        server, service = server_of(*a, **k)
        bound.append(server.server_address[1])
        return server, service

    api._server = recording
    try:
        threading.Thread(target=cli.main, args=(argv,), daemon=True).start()
        deadline = time.monotonic() + 60
        while not bound:
            assert time.monotonic() < deadline, "the server did not start"
            time.sleep(0.05)
    finally:
        api._server = server_of
    return bound[0]


def test_serve_hosts_the_gallery(port_only, corpus, tmp_path, capsys, monkeypatch):
    """explain writes a gallery; `serve` hosts it over HTTP."""
    import http.server

    _run(cli.main, ["explain", "--chunk-long", "--wav", str(corpus / NAMES[0]), "--out",
                    str(tmp_path)], capsys)
    bound: list = []

    class Server(http.server.ThreadingHTTPServer):  # binds a free port
        def __init__(self, addr, handler):
            super().__init__(("127.0.0.1", 0), handler)
            bound.append(self.server_address[1])

    monkeypatch.setattr(http.server, "ThreadingHTTPServer", Server)
    threading.Thread(target=cli.main, args=(["serve", "--artifacts", str(tmp_path)],),
                     daemon=True).start()
    deadline = time.monotonic() + 30
    while not bound:
        assert time.monotonic() < deadline, "the gallery server did not start"
        time.sleep(0.05)
    with urllib.request.urlopen(f"http://127.0.0.1:{bound[0]}/index.html", timeout=30) as r:
        assert b"audio controls" in r.read()


# ---------------------------------------------------------------------------
# refusals, the mesh flags, the device rule, no matplotlib
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["train", "--metadata", "m", "--quant", "int8"],
    ["attrib", "--metadata", "m", "--quant", "int8-static"],
    ["train", "--metadata", "m", "--unet-quant", "int8"],
])
def test_refusals_match_jax(argv, capsys):
    """JAX's refusals: argparse's exit 2 with the same message."""
    msgs = []
    for main in (jcli.main, cli.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ")[1])
    assert msgs[0] == msgs[1]


def test_unet_quant_warns_where_it_does_nothing(port_only, corpus, tmp_path, capsys):
    capsys.readouterr()
    cli.main(["embed", "--unet-quant", "int8", "--metadata", str(corpus / "meta.csv"),
              "--root", str(corpus), "--limit", "2", "--out", str(tmp_path)])
    assert "--unet-quant has no effect here" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["train", "--batch-size", "2", "--epochs", "1", "--data-parallel"],
    ["eval", "--model-parallel"],
    ["closed-loop", "--n-train", "4", "--n-eval", "2", "--epochs", "1", "--batch-size", "2",
     "--pipeline-stages"],
])
def test_mesh_flags_exit_2(argv, port_only, corpus, tmp_path, capsys):
    """A mesh flag lays its mesh over the world of processes (torchrun's;
    here a gloo world of this process alone): 2 ways exit with code 2,
    naming the world, and 1 way runs the job and prints what the job
    without the flag prints. The flags on 8 ranks:
    tests/test_torch_parallel_train.py."""
    import torch.distributed as dist

    cmd, flag = argv[0], argv[-1]
    data = [] if cmd == "closed-loop" else ["--metadata", str(corpus / "meta.csv"), "--root",
                                            str(corpus)]

    def job(name, extra):
        out = [] if cmd == "eval" else ["--out", str(tmp_path / name)]
        return [cmd] + data + argv[1:-1] + out + extra

    try:
        capsys.readouterr()
        with pytest.raises(SystemExit) as e:
            cli.main(job("two", [flag, "2"]))
        assert e.value.code == 2
        assert "world has 1" in capsys.readouterr().err
        got, want = _run(cli.main, job("one", [flag, "1"]), capsys), _run(
            cli.main, job("none", []), capsys)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert got.keys() == want.keys()
    if cmd == "closed-loop":
        assert got["detector"] == want["detector"]
        assert [r["loss"] for r in got["train_log"]] == [r["loss"] for r in want["train_log"]]
    else:
        assert got == want


def test_device_flag_and_no_fallback(monkeypatch, tmp_path):
    """--device defaults to $ADDVISOR_DEVICE, else cuda; cuda without a
    card raises instead of running on the CPU."""
    monkeypatch.delenv("ADDVISOR_DEVICE", raising=False)
    assert cli.build_parser().parse_args(["serve", "--artifacts", "x"]).device == "cuda"
    monkeypatch.setenv("ADDVISOR_DEVICE", "cpu")
    assert cli.build_parser().parse_args(["serve", "--artifacts", "x"]).device == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is valid")
    np.savez(tmp_path / "fx.npz", X=np.zeros((10, 2), np.float32), y=np.arange(10) % 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--device", "cuda", "train-detector", "--features", str(tmp_path / "fx.npz"),
                  "--out", str(tmp_path)])


def test_without_matplotlib_the_pngs_are_skipped(port_only, corpus, tmp_path, monkeypatch,
                                                 capsys):
    """matplotlib blocked: explain writes its wavs, results and gallery,
    names the skipped PNGs once on stderr, and the gallery items carry no
    image keys."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    capsys.readouterr()
    cli.main(["explain", "--chunk-long", "--wav", str(corpus / NAMES[0]),
              str(corpus / NAMES[1]), "--out", str(tmp_path)])
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1])["explained"] == 2
    (line,) = [ln for ln in err.splitlines() if "matplotlib" in ln]
    assert "skipped 10 PNG(s)" in line and "a_mask.png" in line and "b_spec.png" in line
    assert (tmp_path / "a_explanation.wav").is_file() and (tmp_path / "index.html").is_file()
    assert not list(tmp_path.glob("*.png"))
    results = json.loads((tmp_path / "results.json").read_text())
    assert len(results) == 2 and all(not any(k.endswith("_img") for k in r) for r in results)
