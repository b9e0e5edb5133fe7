"""PyTorch port, the slice as a whole: `explain(decoder="unet")` against the
JAX pipeline's `jit_explain` on the CPU at tiny geometry, the port's
independence from JAX, its device rule and the configuration it refuses."""

import copy
import inspect
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_audio_deepfakes_tpu import config as jc
from xai_audio_deepfakes_tpu.models.logreg import LogReg
from xai_audio_deepfakes_tpu.pipeline.core import ADDvisorPipeline as JPipeline
from tests.test_torch_bf16 import _assert_bars, _jax_explain
from tests.test_torch_encoder_import import _OpCounter
from tests.test_torch_models import random_params
from tests.test_torch_quant import _rel_l2
from xai_audio_deepfakes_tpu_torch import config as tc
from xai_audio_deepfakes_tpu_torch.convert import load_jax_params
from xai_audio_deepfakes_tpu_torch.models.logreg import logreg_apply
from xai_audio_deepfakes_tpu_torch.models.wav2vec2 import stack_layer_params
from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "xai_audio_deepfakes_tpu_torch"


def _tiny(mod):
    """The tiny PipelineConfig of tests/test_pipeline.py (its explain path),
    built from either package's config module."""
    return mod.PipelineConfig(
        audio=mod.AudioConfig(clip_seconds=0.5),  # 8000 samples -> 25 STFT frames
        embedder=mod.EmbedderConfig.tiny(),
        unet=mod.UNetConfig(freq_bins=64, frames=24, base_channels=4),
    )


@pytest.fixture(scope="module")
def jax_params():
    """Random numpy weights in the JAX pipeline's tree for the tiny explain
    path (the feature decoder, which explain(decoder="unet") never reads, is
    left out)."""
    cfg = _tiny(jc)
    jpipe = JPipeline(cfg)
    wav = jnp.zeros((1, cfg.audio.num_samples), jnp.float32)
    mag = jnp.zeros((1, cfg.unet.freq_bins, cfg.unet.frames), jnp.float32)
    return {
        "encoder": random_params(jpipe.encoder.init, jax.random.PRNGKey(0), wav, seed=1),
        "unet": random_params(jpipe.unet.init, jax.random.PRNGKey(0), mag, seed=2),
        "logreg": jax.tree.map(np.asarray, LogReg.init(cfg.embedder.hidden_size)),
    }


@pytest.mark.parametrize("masking", ["log1p", "linear"])
def test_explain_matches_jax_jit_explain(jax_params, masking):
    """Same weights (through the bridge), same clips: mask atol 1e-5,
    waveforms 2e-4, the three probabilities 1e-4."""
    params = jax_params
    jpipe = JPipeline(_tiny(jc))
    wav = np.random.default_rng(1).standard_normal((2, 8000)).astype(np.float32) * 0.1
    ref = jpipe.jit_explain(masking=jc.MaskingConvention(masking))(params, jnp.asarray(wav))
    pipe = ADDvisorPipeline(_tiny(tc), device="cpu", seed=9)
    load_jax_params(pipe, params)
    out = pipe.explain(wav, masking=tc.MaskingConvention(masking))
    for name, atol in (("mask", 1e-5), ("magnitude", 1e-4), ("relevant_wav", 2e-4),
                       ("irrelevant_wav", 2e-4), ("probs_clean", 1e-4),
                       ("probs_relevant", 1e-4), ("probs_irrelevant", 1e-4)):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=atol, err_msg=name)


def test_port_runs_without_jax():
    """Import every module of the port, run the tiny explain, the tiny
    detector path (a wav written and read back, band splices and their
    features, the L-BFGS fit) and the vocoded datagen of one file on the CPU
    in a process where `import jax` and `import xai_audio_deepfakes_tpu`
    fail."""
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)  # beside the suite's workers\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['xai_audio_deepfakes_tpu'] = None\n"
        "import numpy as np\n"
        "from xai_audio_deepfakes_tpu_torch import ADDvisorPipeline, PipelineConfig\n"
        "from xai_audio_deepfakes_tpu_torch.config import AudioConfig, EmbedderConfig, UNetConfig\n"
        "cfg = PipelineConfig(audio=AudioConfig(clip_seconds=0.5), embedder=EmbedderConfig.tiny(),\n"
        "                     unet=UNetConfig(freq_bins=64, frames=24, base_channels=4))\n"
        "out = ADDvisorPipeline(cfg, device='cpu').explain(np.zeros((1, 8000), np.float32) + 0.01)\n"
        "assert out.relevant_wav.shape == (1, 8000)\n"
        "import importlib, os, pkgutil, tempfile\n"
        "import xai_audio_deepfakes_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'xai_audio_deepfakes_tpu_torch.train.train_logreg' in names, names\n"
        "from xai_audio_deepfakes_tpu_torch.data import bandswap, datasets, io\n"
        "from xai_audio_deepfakes_tpu_torch.train.train_logreg import evaluate_logreg, fit_logreg\n"
        "pipe = ADDvisorPipeline(cfg, device='cpu')\n"
        "d = tempfile.mkdtemp()\n"
        "rng = np.random.default_rng(0)\n"
        "for i in range(2):\n"
        "    io.write_wav(os.path.join(d, f'{i}.wav'), rng.uniform(-.3, .3, 8000), 16000)\n"
        "batch = next(iter(datasets.AudioBatcher(['0.wav', '1.wav'], 2, root=d,\n"
        "                                        clip_seconds=0.5, num_workers=2)))\n"
        "pairs = [(w, w[::-1].copy()) for w in batch]\n"
        "x, y = bandswap.generate_band_swap_features(\n"
        "    pairs, lambda w: pipe.features(w).mean(dim=1), device='cpu')\n"
        "metrics = evaluate_logreg(fit_logreg(x, y, max_iter=5, device='cpu'), x, y)\n"
        "assert x.shape == (18, 32) and 0 <= metrics['eer'] <= 1\n"
        "from xai_audio_deepfakes_tpu_torch.config import HiFiGANConfig\n"
        "from xai_audio_deepfakes_tpu_torch.data.vocoded import generate_vocoded_dataset\n"
        "hg = HiFiGANConfig(upsample_initial_channel=16)\n"
        "voc = ADDvisorPipeline(cfg.replace(hifigan=hg), device='cpu')\n"
        "n = generate_vocoded_dataset(['0.wav'], d, os.path.join(d, 'bands'), voc.vocode,\n"
        "                             clip_seconds=0.5, device='cpu')\n"
        "assert n == 8, n\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_port_sources_import_no_jax():
    """No JAX and nothing of the JAX package; nor transformers, safetensors
    or scikit-learn, which the card's machine lacks."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|xai_audio_deepfakes_tpu|transformers|"
        r"safetensors|sklearn)(\.|\s|$)", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "profile_explain.py",
                                          ROOT / "closed_loop_protocol.py"]
    assert len(files) > 10
    for path in files:
        hits = pattern.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_default_device_is_cuda():
    """Entry points default to CUDA; without CUDA and without device='cpu'
    they raise instead of falling back."""
    assert inspect.signature(ADDvisorPipeline).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert ADDvisorPipeline(_tiny(tc)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ADDvisorPipeline(_tiny(tc))


@pytest.mark.parametrize("changes", [
    {"scan_layers": True}, {"remat": True, "remat_policy": "dots"},
], ids=lambda c: "-".join(c))
def test_unported_embedder_options_raise(jax_params, changes):
    """The two options the port refused until they were ported are accepted
    and change no number. `scan_layers` is a parameter layout: JAX's tree
    with its layers stacked as a scanned encoder holds them
    (`stack_layer_params`) loads into a scan_layers pipeline whose explain
    equals the unrolled one's bit for bit. "dots" is a checkpoint policy,
    active only where a gradient is taken: the backward of the detector's
    score through `embed` recomputes the LayerNorms (none without remat),
    and its input gradient equals the one without remat (1e-6, the bar of
    tests/test_torch_encoder_import.py)."""
    base = _tiny(tc)
    cfg = base.replace(embedder=tc.dataclasses.replace(base.embedder, **changes))
    wav = np.random.default_rng(8).standard_normal((2, 8000)).astype(np.float32) * 0.1
    pipes = [ADDvisorPipeline(c, device="cpu", seed=2) for c in (cfg, base)]
    if "scan_layers" in changes:
        enc = copy.deepcopy(jax_params["encoder"]["params"])
        stack_layer_params(enc, sum(k.startswith("layer_") for k in enc))
        load_jax_params(pipes[0], dict(jax_params, encoder={"params": enc}))
        load_jax_params(pipes[1], jax_params)
        got, want = (p.explain(wav) for p in pipes)
        for name in ("mask", "relevant_wav", "probs_clean", "probs_relevant", "probs_irrelevant"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        return
    grads, norms = [], []
    for pipe in pipes:
        load_jax_params(pipe, jax_params)
        x = torch.from_numpy(wav).requires_grad_()
        score = logreg_apply(pipe.logreg, pipe.embed(x).mean(dim=1))[0].sum()
        with _OpCounter() as ops:
            grads.append(torch.autograd.grad(score, x)[0])
        norms.append(ops.counts["native_layer_norm"])
    assert norms[0] > 0 == norms[1], norms
    torch.testing.assert_close(grads[0], grads[1], atol=1e-6, rtol=0)


@pytest.mark.parametrize("changes", [
    {"quant": "int8"}, {"quant_conv": "int8", "conv_dim": (128, 128, 128)},
    {"fused_attention": False},
], ids=lambda c: "-".join(c))
def test_formerly_unported_embedder_options_match_jax(jax_params, changes):
    """The f32 explain with the embedder options the port used to refuse,
    against the JAX pipeline's `jit_explain` on the same weights: with
    `fused_attention=False` at the float bars of
    `test_explain_matches_jax_jit_explain`; with int8 the probabilities'
    relative L2 at most 1/10 of JAX's own int8-vs-f32 (quant_conv needs a
    frontend of at least 64 channels)."""
    params = jax_params
    if "conv_dim" in changes:
        jcfg = _tiny(jc)
        jcfg = jcfg.replace(embedder=tc.dataclasses.replace(jcfg.embedder, conv_dim=changes["conv_dim"]))
        params = dict(params, encoder=random_params(
            JPipeline(jcfg).encoder.init, jax.random.PRNGKey(0),
            jnp.zeros((1, 8000), jnp.float32), seed=3))
    wav = np.random.default_rng(4).standard_normal((2, 8000)).astype(np.float32) * 0.1
    outs = {}
    for name, kw in (("float", {k: v for k, v in changes.items() if k == "conv_dim"}),
                     ("changed", changes)):
        jcfg = _tiny(jc)
        jcfg = jcfg.replace(embedder=tc.dataclasses.replace(jcfg.embedder, **kw))
        outs[name] = JPipeline(jcfg).jit_explain()(params, jnp.asarray(wav))
    cfg = _tiny(tc)
    pipe = ADDvisorPipeline(cfg.replace(embedder=tc.dataclasses.replace(cfg.embedder, **changes)),
                            device="cpu", seed=9)
    load_jax_params(pipe, params)
    out, ref = pipe.explain(wav), outs["changed"]
    names = ("probs_clean", "probs_relevant", "probs_irrelevant")
    if "fused_attention" in changes:
        for name in names:
            np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                       atol=1e-4, err_msg=name)
        return
    probs = lambda o: np.concatenate([np.asarray(getattr(o, n)) for n in names])  # noqa: E731
    got = torch.cat([getattr(out, n) for n in names]).numpy()
    assert _rel_l2(got, probs(ref)) <= 0.1 * _rel_l2(probs(ref), probs(outs["float"]))


def test_explain_with_fused_conv_matches_default():
    """`fused_conv=True` is accepted; with conv widths that kernel E covers,
    the f32 explain equals the unfused one (probabilities 1e-5) and serving
    still records no gradient."""
    wide = tc.dataclasses.replace(tc.EmbedderConfig.tiny(), conv_dim=(128, 128, 128))
    cfg = _tiny(tc).replace(embedder=wide)
    fused = cfg.replace(embedder=tc.dataclasses.replace(wide, fused_conv=True, remat=True))
    wav = np.random.default_rng(2).standard_normal((2, 8000)).astype(np.float32) * 0.1
    a = ADDvisorPipeline(cfg, device="cpu", seed=3).explain(wav)
    b = ADDvisorPipeline(fused, device="cpu", seed=3).explain(wav)
    for name in ("probs_clean", "probs_relevant", "probs_irrelevant"):
        torch.testing.assert_close(getattr(b, name), getattr(a, name), atol=1e-5, rtol=0)
        assert not getattr(b, name).requires_grad


@pytest.fixture(scope="module")
def bf16_reference(jax_params):
    """JAX's tiny explain with a bf16 embedder (eager embedder pass, its
    attention kernel in interpret mode) and with an f32 one. At 8 channels
    JAX never takes its LN+GELU kernel, and its CPU STFT is exact f32 at
    every precision, so one reference serves every case below."""
    wav = np.random.default_rng(6).standard_normal((1, 8000)).astype(np.float32) * 0.1
    probs = {}
    for dtype in ("bfloat16", "float32"):
        cfg = _tiny(jc)
        cfg = cfg.replace(embedder=tc.dataclasses.replace(cfg.embedder, dtype=dtype,
                                                          fused_interpret=True))
        probs[dtype] = _jax_explain(JPipeline(cfg), jax_params, jnp.asarray(wav))[3]
    return wav, probs


@pytest.mark.parametrize("fused_ln_gelu,precision", [
    (False, "high"),  # the entry point's configuration: unfused LN, GELU in bf16
    (True, "default"),  # one-pass bf16 DFT on the TPU, exact f32 here as in JAX
    (True, "highest"),
])
def test_formulation_switches(jax_params, bf16_reference, fused_ln_gelu, precision):
    """Every bf16 formulation switch runs, and the explain's probabilities
    match JAX's bf16 explain at the bars of `tests/test_torch_bf16.py`."""
    cfg = _tiny(tc)
    cfg = cfg.replace(
        stft=tc.dataclasses.replace(cfg.stft, precision=precision),
        embedder=tc.dataclasses.replace(cfg.embedder, dtype="bfloat16",
                                        fused_ln_gelu=fused_ln_gelu))
    pipe = ADDvisorPipeline(cfg, device="cpu")
    load_jax_params(pipe, jax_params)
    wav, probs = bf16_reference
    out = pipe.explain(wav)
    got = torch.cat([out.probs_clean, out.probs_relevant, out.probs_irrelevant]).numpy()
    _assert_bars(got, probs["bfloat16"], probs["float32"], "probabilities")


def test_unported_entry_points_raise():
    """Vocoding runs since it was ported (held against JAX in
    tests/test_torch_vocoder.py): 256 samples a mel frame. What is still to
    port is the parallel layer, and its entry points refuse: the sharded
    sweep raises, citing ROADMAP.md."""
    from xai_audio_deepfakes_tpu_torch.metrics.harness import run_explanation_metrics

    pipe = ADDvisorPipeline(_tiny(tc), device="cpu")
    wav = np.zeros((1, 8000), np.float32)
    voc = pipe.vocode(wav)
    assert voc.shape == (1, 256 * (1 + 8000 // 256)) and bool(torch.isfinite(voc).all())
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 11"):
        run_explanation_metrics(pipe, [wav], mesh=object())
