"""PyTorch port, the detector's data: audio I/O (native, scipy and `wave`
decoders), resampling, the dataset scanners and the batcher, waveform
alignment, band-splice generation and the synthetic corpora, against the
JAX package on the CPU.

Bars: exact where both sides run the same numpy or host code (PCM
conventions, file bytes, resampling, scanners, batches, clip generators,
masks, the alignment lag); the STFT bar, 2e-4, for whatever goes through
STFT and iSTFT (the port's plain versions of kernels B and C against JAX's
jitted transforms), with the labels of a corpus equal; the encoder's f32
bar, 5e-4, for band-swap features through `convert.load_jax_params`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile as wavfile
import torch

from xai_audio_deepfakes_tpu.config import STFTConfig as JSTFTConfig
from xai_audio_deepfakes_tpu.data import bandswap as jb
from xai_audio_deepfakes_tpu.data import datasets as jd
from xai_audio_deepfakes_tpu.data import io as jio
from xai_audio_deepfakes_tpu.data import native_io as jnative
from xai_audio_deepfakes_tpu.data import prefetch as jprefetch
from xai_audio_deepfakes_tpu.data import synthetic as js
from xai_audio_deepfakes_tpu.ops import align as jalign
from xai_audio_deepfakes_tpu.ops import resample as jres
from xai_audio_deepfakes_tpu.models.logreg import LogReg
from xai_audio_deepfakes_tpu.pipeline.core import ADDvisorPipeline as JPipeline
from tests.test_pipeline import tiny_config
from tests.test_torch_models import random_params
from tests.test_torch_train import tiny
from xai_audio_deepfakes_tpu_torch.config import STFTConfig
from xai_audio_deepfakes_tpu_torch.convert import load_jax_params
from xai_audio_deepfakes_tpu_torch.data import bandswap as tb
from xai_audio_deepfakes_tpu_torch.data import datasets as td
from xai_audio_deepfakes_tpu_torch.data import io as tio
from xai_audio_deepfakes_tpu_torch.data import native_io as tnative
from xai_audio_deepfakes_tpu_torch.data import synthetic as ts
from xai_audio_deepfakes_tpu_torch.data.prefetch import parallel_map
from xai_audio_deepfakes_tpu_torch.ops import align as talign
from xai_audio_deepfakes_tpu_torch.ops import resample as tres
from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline

CFG, JCFG = STFTConfig(), JSTFTConfig()
STFT_BAR = 2e-4


def _close(got, want, atol=STFT_BAR, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# I/O: native bridge, PCM conventions, file bytes
# ---------------------------------------------------------------------------


def test_native_library_loads_as_in_jax(monkeypatch):
    """The port's bridge loads the committed library exactly where the JAX
    package's does, and reports it unavailable where it is missing."""
    assert tnative.available() == jnative.available()
    monkeypatch.setattr(tnative, "LIBRARY", tnative.LIBRARY.with_name("missing.so"))
    tnative._load.cache_clear()
    try:
        assert not tnative.available()
        assert tnative.read_wav_native("x.wav") is None
        assert not tnative.write_wav_native("x.wav", np.zeros(4, np.float32), 16000)
    finally:
        monkeypatch.undo()
        tnative._load.cache_clear()


@pytest.mark.parametrize("native", [True, False], ids=["native", "scipy"])
@pytest.mark.parametrize("channels", [1, 2])
def test_write_wav_bytes_equal_jax(tmp_path, native, channels, monkeypatch):
    """write_wav gives the JAX package's bytes (clip, x32767, truncate), by
    the native encoder and by scipy, mono and [C, L] stereo; read_wav gives
    JAX's arrays back."""
    if native and not jnative.available():
        pytest.skip("the native library does not load here")
    wav = np.random.default_rng(channels).uniform(-1.3, 1.3, (channels, 3001)).astype(np.float32)
    wav = wav[0] if channels == 1 else wav
    if not native:
        monkeypatch.setattr(tnative, "write_wav_native", lambda *a: False)
        monkeypatch.setattr(jnative, "write_wav_native", lambda *a: False)
    tio.write_wav(str(tmp_path / "t.wav"), wav, 22050)
    jio.write_wav(str(tmp_path / "j.wav"), wav, 22050)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    got, sr = tio.read_wav(str(tmp_path / "t.wav"))
    want, jsr = jio.read_wav(str(tmp_path / "j.wav"))
    assert sr == jsr == 22050 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["int16", "int32", "uint8", "float32"])
def test_read_wav_pcm_conventions_equal_jax(tmp_path, dtype):
    """Formats the native decoder leaves to scipy: int32, uint8, float32
    (and int16 through whichever path loads)."""
    rng = np.random.default_rng(3)
    if dtype == "float32":
        data = rng.uniform(-1, 1, (500, 2)).astype(np.float32)
    else:
        info = np.iinfo(dtype)
        data = rng.integers(info.min, info.max, (500, 2), endpoint=True).astype(dtype)
    path = str(tmp_path / f"{dtype}.wav")
    wavfile.write(path, 8000, data)
    got, sr = tio.read_wav(path)
    want, jsr = jio.read_wav(path)
    assert sr == jsr == 8000 and got.shape == (2, 500)
    np.testing.assert_array_equal(got, want)
    got_b, sr_b = tio.decode_wav_bytes(open(path, "rb").read())
    want_b, _ = jio.decode_wav_bytes(open(path, "rb").read())
    assert sr_b == 8000
    np.testing.assert_array_equal(got_b, want_b)


def test_wave_fallback_equals_jax(tmp_path, monkeypatch):
    """Where scipy fails, the standard library's `wave` decodes (16- and
    8-bit PCM, stereo), as in the JAX package."""
    import wave

    rng = np.random.default_rng(4)
    for width, dtype in ((2, "<i2"), (1, np.uint8)):
        path = str(tmp_path / f"w{width}.wav")
        frames = rng.integers(0, 255 if width == 1 else 32767, 600).astype(dtype)
        with wave.open(path, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(width)
            w.setframerate(16000)
            w.writeframes(frames.tobytes())
        monkeypatch.setattr(tnative, "read_wav_native", lambda p: None)
        monkeypatch.setattr(jnative, "read_wav_native", lambda p: None)
        monkeypatch.setattr(wavfile, "read", lambda *a: (_ for _ in ()).throw(ValueError("no")))
        got, sr = tio.read_wav(path)
        want, _ = jio.read_wav(path)
        assert sr == 16000 and got.shape == (2, 300)
        np.testing.assert_array_equal(got, want)
        data = open(path, "rb").read()
        np.testing.assert_array_equal(tio.decode_wav_bytes(data)[0], jio.decode_wav_bytes(data)[0])
        monkeypatch.undo()


def test_load_audio_and_chunks_equal_jax(tmp_path):
    """load_audio (22.05 kHz stereo -> 16 kHz mono, padded to 5 s), the
    same over bytes, load_audio_chunks with and without overlap, and
    wav_to_bytes: equal to the JAX package's."""
    rng = np.random.default_rng(5)
    wav = rng.uniform(-0.5, 0.5, (2, 22050 * 2 + 137)).astype(np.float32)
    path = str(tmp_path / "s.wav")
    jio.write_wav(path, wav, 22050)
    got, sr = tio.load_audio(path)
    want, _ = jio.load_audio(path)
    assert sr == 16000 and got.shape == (80000,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    data = open(path, "rb").read()
    np.testing.assert_array_equal(tio.load_audio_bytes(data, clip_seconds=1.0)[0],
                                  jio.load_audio_bytes(data, clip_seconds=1.0)[0])
    for hop in (None, 0.4):
        got_c, got_s = tio.load_audio_chunks(path, clip_seconds=1.0, hop_seconds=hop)
        want_c, want_s = jio.load_audio_chunks(path, clip_seconds=1.0, hop_seconds=hop)
        np.testing.assert_array_equal(got_c, want_c)
        np.testing.assert_array_equal(got_s, want_s)
    with pytest.raises(ValueError, match="hop_seconds"):
        tio.load_audio_chunks(path, hop_seconds=0.0)
    assert tio.wav_to_bytes(wav[0]) == jio.wav_to_bytes(wav[0])


# ---------------------------------------------------------------------------
# resampling and alignment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("orig,new", [(22050, 16000), (48000, 16000), (8000, 16000),
                                      (16000, 16000)])
def test_resample_equals_jax(orig, new):
    """The kernel bank and the numpy path bit for bit; the torch path within
    1e-6 of JAX's device path (the same products, another summation order)."""
    x = np.random.default_rng(6).standard_normal((2, 4321)).astype(np.float32)
    if orig != new:
        for mine, ref in zip(tres._sinc_kernels(orig, new), jres._sinc_kernels(orig, new)):
            np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(tres.resample_poly_np(x[0], orig, new),
                                  jres.resample_poly_np(x[0], orig, new))
    got = tres.resample_torch(torch.from_numpy(x), orig, new)
    want = jres.resample_jnp(jnp.asarray(x), orig, new)
    assert tuple(got.shape) == want.shape
    _close(got, want, 1e-6)
    _close(got[0], tres.resample_poly_np(x[0], orig, new), 1e-6)


@pytest.mark.parametrize("shift", [123, -57, 0])
def test_xcorr_shift_and_alignment_equal_jax(shift):
    """The lag is JAX's exactly, and the aligned clips are its arrays."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(4000).astype(np.float32)
    # deg delayed by `shift` samples (advanced where it is negative)
    deg = np.concatenate([np.zeros(shift, np.float32), x])[:4000] if shift >= 0 else \
        np.concatenate([x[-shift:], np.zeros(-shift, np.float32)])
    deg = (deg + 0.01 * rng.standard_normal(4000)).astype(np.float32)
    got = talign.xcorr_shift(torch.from_numpy(x), torch.from_numpy(deg))
    assert int(got) == int(jalign.xcorr_shift(jnp.asarray(x), jnp.asarray(deg))) == -shift
    for mine, ref in zip(talign.align_waveforms(x, deg, device="cpu"),
                         jalign.align_waveforms(x, deg)):
        np.testing.assert_array_equal(mine, ref)


# ---------------------------------------------------------------------------
# scanners, batcher, parallel_map
# ---------------------------------------------------------------------------


def _tree(root, paths):
    for p in paths:
        full = os.path.join(root, p)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        jio.write_wav(full, np.zeros(50, np.float32))


def test_scanners_equal_jax(tmp_path):
    meta = tmp_path / "m.txt"
    meta.write_text("a.wav,foo\nb.wav\n\n  c.wav,x,y\n")
    assert td.extract_wavs(str(meta)) == jd.extract_wavs(str(meta)) == ["a.wav", "b.wav", "c.wav"]
    mlaad = [f"fake/{lang}/{system}/{sub}{i}.wav" for lang, system in
             (("en", "sysA"), ("en", "sysB"), ("de", "sysA"), ("de", "sysC"))
             for sub in ("", "deep/") for i in range(3)]
    _tree(tmp_path / "mlaad", mlaad + ["fake/en/notes.txt"])
    mailabs = [f"{lang}/{lang}/by_book/{g}/{spk}/{book}/wavs/{i}.wav"
               for lang in ("de_DE", "en_US") for g in ("female", "male")
               for spk in (f"{g}1", f"{g}2") for book in ("b1", "b2") for i in range(4)]
    _tree(tmp_path / "mailabs", mailabs)
    for seed in (0, 1):
        for n in (1, 2, 5):
            assert (td.find_all_wav_files_per_system(str(tmp_path / "mlaad"), n, seed)
                    == jd.find_all_wav_files_per_system(str(tmp_path / "mlaad"), n, seed))
        for per_lang, per_spk in ((6, 3), (20, 2), (1, 5)):
            got = td.find_wavs_per_language_and_speaker(str(tmp_path / "mailabs"), per_lang,
                                                        per_spk, seed)
            assert got == jd.find_wavs_per_language_and_speaker(
                str(tmp_path / "mailabs"), per_lang, per_spk, seed)
            assert got
    assert td.find_all_wav_files_per_system(str(tmp_path / "nope")) == []
    assert td.find_wavs_per_language_and_speaker(str(tmp_path / "nope")) == []


@pytest.mark.parametrize("kw", [
    dict(batch_size=2, seed=1),
    dict(batch_size=3, seed=2, drop_remainder=False, num_workers=1),
    dict(batch_size=1, shuffle=False, shard_index=1, num_shards=2),
    dict(batch_size=2, seed=3, shard_index=0, num_shards=3, drop_remainder=False),
], ids=["shuffle", "ragged-tail", "shard-1-of-2", "shard-0-of-3"])
def test_audio_batcher_equals_jax(tmp_path, kw):
    """The same files in the same batches, bit for bit, over two epochs of
    one batcher (the order is drawn from one seeded generator per epoch)."""
    rng = np.random.default_rng(8)
    names = []
    for i in range(7):
        names.append(f"{i}.wav")
        jio.write_wav(str(tmp_path / names[-1]), rng.uniform(-0.5, 0.5, 6000 + 500 * i)
                      .astype(np.float32), 16000 if i % 2 else 22050)
    common = dict(root=str(tmp_path), clip_seconds=0.5, **kw)
    mine, ref = td.AudioBatcher(names, **common), jd.AudioBatcher(names, **common)
    assert len(mine) == len(ref) > 0
    for _ in range(2):
        got, want = list(mine), list(ref)
        assert len(got) == len(want) == len(ref)
        for a, b in zip(got, want):
            assert a.dtype == np.float32 and a.shape[1] == 8000
            np.testing.assert_array_equal(a, b)


def test_parallel_map_keeps_order_and_raises():
    items = list(range(40))
    assert parallel_map(lambda v: v * v, items, 8) == jprefetch.parallel_map(
        lambda v: v * v, items, 8) == [v * v for v in items]
    assert parallel_map(str, [3], 8) == ["3"]

    def boom(v):
        if v == 5:
            raise RuntimeError("decode failed")
        return v

    with pytest.raises(RuntimeError, match="decode failed"):
        parallel_map(boom, items, 4)


# ---------------------------------------------------------------------------
# band splices and synthetic corpora (through kernels B and C's plain versions)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [(513, 16000, 1000.0, 8000.0), (257, 16000, 500.0, 4000.0),
                                  (513, 22050, 1000.0, 11025.0)])
def test_band_masks_and_indicators_equal_jax(args):
    np.testing.assert_array_equal(tb.band_masks(*args), jb.band_masks(*args))
    bands = np.array([[0.0, 1000.0], [3000.0, 4000.0], [7000.0, 8000.0], [250.0, 5500.0]])
    np.testing.assert_array_equal(ts.per_clip_band_indicator(CFG, bands),
                                  js.per_clip_band_indicator(JCFG, bands))
    np.testing.assert_array_equal(ts.band_indicator(CFG, 2000.0, 3000.0),
                                  js.band_indicator(JCFG, 2000.0, 3000.0))


def test_clip_generators_equal_jax():
    """The same draws from the same generator: speech-like clips, noise
    sources and random spectral masks bit for bit, and the generator left
    in the same state."""
    mine, ref = np.random.default_rng(9), np.random.default_rng(9)
    np.testing.assert_array_equal(ts.speechlike_clips(mine, 3, 4000),
                                  js.speechlike_clips(ref, 3, 4000))
    np.testing.assert_array_equal(ts.noise_clips(mine, 2, 4000, rms=0.3),
                                  js.noise_clips(ref, 2, 4000, rms=0.3))
    for _ in range(3):
        np.testing.assert_array_equal(ts.random_spectral_mask(mine, CFG),
                                      js.random_spectral_mask(ref, JCFG))
    assert mine.integers(1 << 30) == ref.integers(1 << 30)


def test_band_spliced_waveforms_equal_jax():
    """All 8 band splices of a pair at the STFT bar, the leakage within 1e-4
    of JAX's relative; a clip spliced with itself comes back (and leaks 0)."""
    rng = np.random.default_rng(10)
    real, voc = (rng.standard_normal(8000).astype(np.float32) * 0.1 for _ in range(2))
    waves, leak = tb.band_spliced_waveforms(torch.from_numpy(real), torch.from_numpy(voc), CFG)
    jw, jl = jax.jit(lambda a, b: jb.band_spliced_waveforms(a, b, JCFG))(
        jnp.asarray(real), jnp.asarray(voc))
    assert tuple(waves.shape) == (8, 8000) and tuple(leak.shape) == (8,)
    _close(waves, jw)
    np.testing.assert_allclose(leak.numpy(), np.asarray(jl), rtol=1e-4)
    same, leak0 = tb.band_spliced_waveforms(torch.from_numpy(real), torch.from_numpy(real), CFG,
                                            length=7000)
    _close(same, np.broadcast_to(real[:7000], (8, 7000)), 1e-4)
    assert float(leak0.max()) < 1e-10


@pytest.mark.parametrize("keep", [True, False])
def test_splices_and_filters_equal_jax(keep):
    """splice_band, band_filter and their per-clip forms at the STFT bar."""
    rng = np.random.default_rng(11)
    real = rng.standard_normal((3, 8000)).astype(np.float32) * 0.1
    src = rng.standard_normal((3, 8000)).astype(np.float32) * 0.5
    ind = ts.per_clip_band_indicator(CFG, np.array([[0.0, 1e3], [2e3, 3e3], [5e3, 6e3]]))
    r, s, i = torch.from_numpy(real), torch.from_numpy(src), torch.from_numpy(ind)
    jr, jsrc, ji = jnp.asarray(real), jnp.asarray(src), jnp.asarray(ind)
    pairs = [
        (ts.splice_band(r, s, CFG, 1e3, 2e3), js.splice_band(jr, jsrc, JCFG, 1e3, 2e3)),
        (ts.band_filter(r, CFG, 1e3, 2e3, keep), js.band_filter(jr, JCFG, 1e3, 2e3, keep)),
        (ts.splice_band_per_clip(r, s, CFG, ind), js.splice_band_per_clip(jr, jsrc, JCFG, ji)),
        (ts.band_filter_per_clip(r, CFG, i, keep), js.band_filter_per_clip(jr, JCFG, ji, keep)),
    ]
    for n, (got, want) in enumerate(pairs):
        _close(got, want, what=str(n))


def test_anyband_corpus_equals_jax():
    """make_anyband_corpus and detector_corpus_anyband (sweep, 2 random
    masks) from the same seed: clips within the STFT bar, labels and bands
    equal."""
    real, man, bands = ts.make_anyband_corpus(np.random.default_rng(12), 4, 8000, CFG,
                                              device="cpu")
    jreal, jman, jbands = js.make_anyband_corpus(np.random.default_rng(12), 4, 8000, JCFG)
    np.testing.assert_array_equal(real, jreal)
    np.testing.assert_array_equal(bands, jbands)
    _close(man, jman)
    wavs, labels = ts.detector_corpus_anyband(real, man, CFG, bands,
                                              rng=np.random.default_rng(13), n_random_masks=2,
                                              device="cpu")
    jwavs, jlabels = js.detector_corpus_anyband(jreal, jman, JCFG, jbands,
                                                rng=np.random.default_rng(13), n_random_masks=2)
    np.testing.assert_array_equal(labels, jlabels)
    assert wavs.shape == jwavs.shape and wavs.dtype == np.float32
    _close(wavs, jwavs)


def test_fixed_band_corpora_equal_jax():
    """make_bandswap_corpus and detector_corpus (with and without augment,
    with random masks) from the same seed, at the STFT bar."""
    real, man = ts.make_bandswap_corpus(np.random.default_rng(14), 3, 8000, CFG, 2e3, 3e3,
                                        device="cpu")
    jreal, jman = js.make_bandswap_corpus(np.random.default_rng(14), 3, 8000, JCFG, 2e3, 3e3)
    np.testing.assert_array_equal(real, jreal)
    _close(man, jman)
    for kw in (dict(augment=False), dict(rng=None), dict(n_random_masks=5)):
        t_kw = dict(kw, rng=np.random.default_rng(15)) if "rng" not in kw else kw
        j_kw = dict(kw, rng=np.random.default_rng(15)) if "rng" not in kw else kw
        wavs, labels = ts.detector_corpus(real, man, CFG, 2e3, 3e3, device="cpu", **t_kw)
        jwavs, jlabels = js.detector_corpus(jreal, jman, JCFG, 2e3, 3e3, **j_kw)
        np.testing.assert_array_equal(labels, jlabels)
        _close(wavs, jwavs, what=str(kw))


def test_corpus_functions_default_to_cuda():
    """Without CUDA and without device='cpu' the device-side corpus functions raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    real = np.zeros((1, 8000), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ts.make_anyband_corpus(np.random.default_rng(0), 1, 8000, CFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ts.detector_corpus(real, real, CFG, 0.0, 1e3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tb.generate_band_swap_features([(real[0], real[0])], lambda w: w)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        talign.align_waveforms(real[0], real[0])


def test_band_swap_features_equal_jax():
    """generate_band_swap_features over two pairs through the tiny encoder
    with JAX's weights: X [18, H] within the encoder's f32 bar, y equal
    (0 for each real clip, then 1 for its 8 splices); embed_fn sees batch 1
    then batch 8, and a pair over the leakage threshold is logged in both
    (a splice leaks nothing outside its band: the threshold is set below 0)."""
    cfg = tiny_config()
    jpipe = JPipeline(cfg)
    params = {
        "encoder": random_params(jpipe.encoder.init, jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8000), jnp.float32), seed=1),
        "unet": random_params(jpipe.unet.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 64, 24), jnp.float32), seed=2),
        "logreg": jax.tree.map(np.asarray, LogReg.init(cfg.embedder.hidden_size, seed=3)),
    }
    pipe = ADDvisorPipeline(tiny(), device="cpu", seed=4)
    load_jax_params(pipe, params)
    rng = np.random.default_rng(16)
    pairs = [(rng.standard_normal(8000).astype(np.float32) * 0.1,
              rng.standard_normal(8000).astype(np.float32) * 0.3) for _ in range(2)]
    batches, logs, jlogs = [], [], []

    def embed(w):
        batches.append(w.shape[0])
        return pipe.features(w).mean(dim=1)

    x, y = tb.generate_band_swap_features(pairs, embed, log_fn=logs.append, leakage_warn=-1.0,
                                          device="cpu")
    j_embed = jax.jit(lambda w: jnp.mean(jpipe.features(params, w), axis=1))
    jx, jy = jb.generate_band_swap_features(pairs, j_embed, log_fn=jlogs.append,
                                            leakage_warn=-1.0)
    assert x.shape == jx.shape == (18, cfg.embedder.hidden_size) and x.dtype == np.float32
    np.testing.assert_array_equal(y, jy)
    assert y.tolist() == ([0] + [1] * 8) * 2 and batches == [1, 8, 1, 8]
    np.testing.assert_allclose(x, jx, rtol=0, atol=5e-4)
    assert [k["warning"] for k in logs] == [k["warning"] for k in jlogs] == [
        "band-splice leakage"] * 2
    np.testing.assert_allclose([k["max_leakage"] for k in logs],
                               [k["max_leakage"] for k in jlogs], rtol=1e-4)
