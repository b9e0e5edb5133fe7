"""PyTorch port, the vocoder and the listenable path: the slaney mel
filterbank and `mel_spectrogram`, the HiFi-GAN generator and its
state-dict import, `generate_vocoded_dataset` and `explain_vocoded`,
against the JAX package on the CPU at tiny geometry (the HiFi-GAN of
`tests/test_pipeline.py::tiny_config`).

Bars: the filterbank bit for bit; the mel before the log at the STFT bar
(2e-4), the log only where the mel is above 100x the 1e-5 clip (near the
clip an absolute 1e-6 error is a 10% log error): there 1e-4; the generator
in f32 at 1e-5; the importer's weights bit for bit with JAX's through the
bridge; the written wavs within one 16-bit step; `explain_vocoded` at the
explain's bars (mask 1e-5, waveforms 2e-4, probabilities 1e-4) and the
vocoded clip at 1e-5.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_audio_deepfakes_tpu import config as jc
from xai_audio_deepfakes_tpu.data import vocoded as jvoc
from xai_audio_deepfakes_tpu.data.io import read_wav as j_read_wav
from xai_audio_deepfakes_tpu.data.io import write_wav as j_write_wav
from xai_audio_deepfakes_tpu.models import hifigan as jhg
from xai_audio_deepfakes_tpu.models.logreg import LogReg
from xai_audio_deepfakes_tpu.ops import mel as jmel
from xai_audio_deepfakes_tpu.pipeline.core import ADDvisorPipeline as JPipeline
from tests.test_pipeline import tiny_config
from tests.test_torch_models import random_params
from xai_audio_deepfakes_tpu_torch import config as tc
from xai_audio_deepfakes_tpu_torch.convert import load_hifigan, load_jax_params
from xai_audio_deepfakes_tpu_torch.data import vocoded as tvoc
from xai_audio_deepfakes_tpu_torch.data.io import read_wav
from xai_audio_deepfakes_tpu_torch.models import hifigan as thg
from xai_audio_deepfakes_tpu_torch.ops import mel as tmel
from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline

TINY_HG = tc.HiFiGANConfig(**dataclasses.asdict(tiny_config().hifigan))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several xdist workers on a few cores: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny() -> tc.PipelineConfig:
    """tests/test_pipeline.py::tiny_config (its HiFi-GAN included) in the
    port's config."""
    return tc.PipelineConfig(
        audio=tc.AudioConfig(clip_seconds=0.5), embedder=tc.EmbedderConfig.tiny(),
        unet=tc.UNetConfig(freq_bins=64, frames=24, base_channels=4),
        feat_decoder=tc.FeatDecoderConfig(feature_dim=32, hidden=16), hifigan=TINY_HG)


def test_configs_match_jax():
    for mine, ref in ((tc.MelConfig(), jc.MelConfig()), (tc.HiFiGANConfig(), jc.HiFiGANConfig()),
                      (TINY_HG, tiny_config().hifigan)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(tc.PipelineConfig)] == [
        f.name for f in dataclasses.fields(jc.PipelineConfig)]
    assert dataclasses.asdict(tc.MeshConfig()) == dataclasses.asdict(jc.MeshConfig())
    assert dataclasses.asdict(tc.EmbedderConfig.xls_r_2b_full()) == dataclasses.asdict(
        jc.EmbedderConfig.xls_r_2b_full())


@pytest.mark.parametrize("key", [(16000, 1024, 80, 0.0, 8000.0), (22050, 1024, 80, 0.0, 8000.0),
                                 (16000, 512, 40, 50.0, 7600.0)])
def test_mel_filterbank_bit_for_bit(key):
    np.testing.assert_array_equal(tmel.mel_filterbank(*key), jmel.mel_filterbank(*key))


def test_mel_spectrogram_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 8000)) * 0.1).astype(np.float32)
    x[1, 4000:] = 0.0  # silence: mels at the clip
    cfg = tc.MelConfig()
    raw = tmel.mel_spectrogram(torch.from_numpy(x), cfg, compression=False).numpy()
    want_raw = np.asarray(jmel.mel_spectrogram(jnp.asarray(x), jc.MelConfig(), compression=False))
    assert raw.shape == want_raw.shape == (2, 80, 32)
    np.testing.assert_allclose(raw, want_raw, atol=2e-4)
    log = tmel.mel_spectrogram(torch.from_numpy(x), cfg).numpy()
    want = np.asarray(jmel.mel_spectrogram(jnp.asarray(x), jc.MelConfig()))
    np.testing.assert_allclose(log, np.log(np.maximum(raw, 1e-5)), rtol=0, atol=1e-6)
    far = want_raw > 100 * cfg.compression_clip
    assert far.mean() > 0.4 and (~far).any()
    np.testing.assert_allclose(log[far], want[far], atol=1e-4)


@pytest.fixture(scope="module")
def jax_params():
    """Random weights of JAX's tiny pipeline, its HiFi-GAN included, as numpy
    (drawn from the init's shapes: no op-by-op initialiser runs)."""
    jpipe = JPipeline(tiny_config())
    key = jax.random.PRNGKey(0)
    return {
        "encoder": random_params(jpipe.encoder.init, key, jnp.zeros((1, 8000)), seed=1),
        "unet": random_params(jpipe.unet.init, key, jnp.zeros((1, 64, 24)), seed=2),
        "logreg": jax.tree.map(np.asarray, LogReg.init(32, seed=3)),
        "hifigan": random_params(jpipe.hifigan.init, key, jnp.zeros((1, 80, 8)), seed=4),
    }


def test_tiny_hifigan_matches_flax(jax_params):
    """f32, the same weights through the bridge, both mel layouts."""
    module, variables = jhg.HiFiGANGenerator(tiny_config().hifigan), jax_params["hifigan"]
    model = thg.HiFiGANGenerator(TINY_HG)
    load_hifigan(model, variables)
    mel = np.random.default_rng(1).standard_normal((2, 80, 20)).astype(np.float32)
    want = np.asarray(module.apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(mel)))
    with torch.no_grad():
        got = model(torch.from_numpy(mel)).numpy()
        got_nwc = model(torch.from_numpy(mel.transpose(0, 2, 1).copy())).numpy()
    assert got.shape == want.shape == (2, 20 * 8)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got_nwc, got)


def _torch_state_dict(layout: str, seed: int) -> dict:
    """A random weight-normed state dict of the tiny generator, in the
    jik876 / SpeechBrain naming, as `layout` ("weight_g" or
    "parametrizations") stores weight norm."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in thg.HiFiGANGenerator(TINY_HG).state_dict().items()}
    sd = {}
    for key, shape in shapes.items():
        prefix, leaf = key.rsplit(".", 1)
        if leaf == "bias":
            sd[key] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.1)
            continue
        g = torch.from_numpy(rng.uniform(0.5, 2.0, (shape[0], 1, 1)).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        if layout == "weight_g":
            sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"] = g, v
        else:
            sd[f"{prefix}.parametrizations.weight.original0"] = g
            sd[f"{prefix}.parametrizations.weight.original1"] = v
    return sd


@pytest.mark.parametrize("layout", ["weight_g", "parametrizations"])
def test_params_from_torch_state_dict_matches_jax(layout):
    """Weight norm materialised from either key layout: the port's importer
    gives, bit for bit, the weights JAX's importer gives through the
    bridge, and the effective weight is g v / |v| (torch's own weight norm
    on the same g and v, 1e-6)."""
    sd = _torch_state_dict(layout, seed=3)
    mine = thg.params_from_torch_state_dict(sd, TINY_HG)
    ref = thg.HiFiGANGenerator(TINY_HG)
    load_hifigan(ref, jax.tree.map(np.asarray, jhg.params_from_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, tiny_config().hifigan)))
    model = thg.HiFiGANGenerator(TINY_HG)
    model.load_state_dict(mine)
    for key, value in ref.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key
    g_key = ("conv_pre.weight_g" if layout == "weight_g"
             else "conv_pre.parametrizations.weight.original0")
    v = sd[g_key.replace("weight_g", "weight_v").replace("original0", "original1")]
    want = torch._weight_norm(v, sd[g_key], 0)
    torch.testing.assert_close(mine["conv_pre.weight"], want, atol=1e-6, rtol=0)


def test_explain_vocoded_matches_jax(jax_params):
    """The whole listenable path: `explain` at its bars, the vocoded
    relevant clip at 1e-5 (the HiFi-GAN's f32 bar; its mel input comes from
    the relevant waveform within 2e-4), 256 samples per mel frame."""
    wav = (np.random.default_rng(4).standard_normal((2, 8000)) * 0.1).astype(np.float32)
    ref, ref_voc = JPipeline(tiny_config()).jit_explain_vocoded()(
        jax.tree.map(jnp.asarray, jax_params), jnp.asarray(wav))
    pipe = ADDvisorPipeline(tiny(), device="cpu", seed=9)
    load_jax_params(pipe, jax_params)
    out, voc = pipe.explain_vocoded(wav)
    for name, atol in (("mask", 1e-5), ("relevant_wav", 2e-4), ("irrelevant_wav", 2e-4),
                       ("probs_clean", 1e-4), ("probs_relevant", 1e-4),
                       ("probs_irrelevant", 1e-4)):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=atol, err_msg=name)
    assert voc.shape == ref_voc.shape == (2, (1 + 8000 // 256) * 8)
    np.testing.assert_allclose(voc.numpy(), np.asarray(ref_voc), atol=1e-5)
    torch.testing.assert_close(pipe.vocode(out.relevant_wav), voc, atol=0, rtol=0)
    assert not voc.requires_grad


def test_pipeline_hifigan_is_drawn_at_first_use():
    """The generator is built at its first use from the pipeline's seeded
    generator, after every other module: two pipelines of one seed agree,
    and the modules drawn before it keep their weights."""
    a, b = (ADDvisorPipeline(tiny(), device="cpu", seed=3) for _ in range(2))
    unet = {k: v.clone() for k, v in a.unet.state_dict().items()}
    wav = np.full((1, 8000), 0.01, np.float32)
    torch.testing.assert_close(a.vocode(wav), b.vocode(wav), atol=0, rtol=0)
    for k, v in a.unet.state_dict().items():
        assert torch.equal(v, unet[k]), k
    assert a.hifigan is a.hifigan and not any(p.requires_grad for p in a.hifigan.parameters())


def test_generate_vocoded_dataset_matches_jax(tmp_path):
    """Both generators over the same two wavs with one deterministic
    "vocoder" (a 37-sample delay, a gain and a tone: the alignment has a lag
    to find): the same 16 file names, every sample within one 16-bit step
    of JAX's, no leakage warning on either side; a missing file is
    skipped."""
    rng = np.random.default_rng(5)
    (tmp_path / "wavs").mkdir()
    names = []
    for i in range(2):
        names.append(f"clip{i}.wav")
        j_write_wav(str(tmp_path / "wavs" / names[-1]),
                    rng.uniform(-0.3, 0.3, 16000).astype(np.float32))
    logs = {"jax": [], "port": []}

    def j_voc(w):
        return jnp.roll(w, 37, axis=-1) * 0.8 + 0.05 * jnp.sin(jnp.arange(w.shape[-1]) * 0.3)

    def t_voc(w):
        return torch.roll(w, 37, -1) * 0.8 + 0.05 * torch.sin(torch.arange(w.shape[-1]) * 0.3)

    n_j = jvoc.generate_vocoded_dataset(names, str(tmp_path / "wavs"), str(tmp_path / "jax"),
                                        j_voc, clip_seconds=1.0, log_fn=logs["jax"].append)
    n_t = tvoc.generate_vocoded_dataset(names + ["missing.wav"], str(tmp_path / "wavs"),
                                        str(tmp_path / "port"), t_voc, clip_seconds=1.0,
                                        log_fn=logs["port"].append, device="cpu")
    files = sorted(os.listdir(tmp_path / "port"))
    assert n_j == n_t == 16 and files == sorted(os.listdir(tmp_path / "jax"))
    assert "clip1.wav_vocoded_7000-8000.wav" in files
    assert logs == {"jax": [], "port": []}
    for name in files:
        got, sr = read_wav(str(tmp_path / "port" / name))
        want, sr_j = j_read_wav(str(tmp_path / "jax" / name))
        assert sr == sr_j == 16000 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1.01 / 32768)


def test_make_vocoder_fn_is_the_pipelines_vocode():
    pipe = ADDvisorPipeline(tiny(), device="cpu", seed=1)
    wav = torch.full((1, 8000), 0.02)
    torch.testing.assert_close(tvoc.make_vocoder_fn(pipe)(wav), pipe.vocode(wav), atol=0, rtol=0)
    cfg = tvoc.hann_splice_config()
    assert (cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.window) == (1024, 256, 1024, "hann")
