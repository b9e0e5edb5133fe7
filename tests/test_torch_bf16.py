"""PyTorch port, the bf16 path against the JAX package on the CPU at tiny
geometry: the cast points of GELU, of Dense and conv biases and of the
frontend's LayerNorm + GELU dispatch, the bf16 embedder in every frontend
formulation, the bf16 UNet, the entry point's bf16 explain, the unfused
attention path and the STFT precision switch.

The bf16 reference is the JAX source's cast points, which eager `apply`
follows. Under `jax.jit` XLA's CPU fusion drops some of those roundings
(`xla_allow_excess_precision`); compiled with that option off (`_strict`),
jit gives eager's result bit for bit on the UNet (float and int8), which
compiles far faster than eager op-by-op runs, but not on the embedder,
which therefore runs eager (`python -m tests.test_torch_bf16` reports both).

Bars for a bf16 model output: the port-vs-JAX mean absolute error is at most
0.4x JAX's own bf16-vs-f32 mean deviation on the same inputs, and its max at
most that deviation's max or two bf16 steps at the output's largest
magnitude, whichever is larger. What is left is f32 rounding inside fused
operations (sum orders of convolutions and reductions, the Pallas bodies'
exp-only erf and tanh), which moves a bf16 rounding now and then; carried
through the layers, such a move reaches one or two steps at the largest
values, about as far as JAX's own bf16-vs-f32 max (at the 128-channel
frontend with kernel D, over six input draws, 0.66x to 1.13x of it, 0.094
against 2 steps of 0.0625 at most; the mean at 0.18x to 0.26x).
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_audio_deepfakes_tpu import config as jc
from xai_audio_deepfakes_tpu.models import wav2vec2 as jw
from xai_audio_deepfakes_tpu.models.unet import UNetMaskDecoder as JUNet
from xai_audio_deepfakes_tpu.ops.masking import apply_mask, remask_complex
from xai_audio_deepfakes_tpu.ops.normalize import zero_mean_unit_var_norm as j_norm
from xai_audio_deepfakes_tpu.pipeline.core import ADDvisorPipeline as JPipeline
from tests.test_torch_models import TINY_UNET, random_params
from xai_audio_deepfakes_tpu_torch import config as tc
from xai_audio_deepfakes_tpu_torch.convert import load_encoder, load_jax_params, load_unet
from xai_audio_deepfakes_tpu_torch.models import wav2vec2 as tw
from xai_audio_deepfakes_tpu_torch.models.unet import UNetMaskDecoder
from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline

BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small graphs: torch's intra-op pool only adds overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _strict(fn, *args):
    """jit with `xla_allow_excess_precision` off: every bf16 rounding the
    source writes is kept."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


def _bf16_pair(rng, shape, scale=1.0):
    """The same bf16 values as a JAX array and a torch tensor."""
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * scale).astype(jnp.bfloat16)
    return x, torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(BF16)


def _assert_bars(mine, ref, ref_f32, what: str):
    """mean |port - JAX| <= 0.4 mean |JAX bf16 - JAX f32|; max |port - JAX|
    <= max(its max, two bf16 steps at max |JAX|)."""
    err, own = np.abs(mine - ref), np.abs(ref - ref_f32)
    two_steps = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7 + 1)
    assert err.mean() <= 0.4 * own.mean(), (what, err.mean(), own.mean())
    assert err.max() <= max(own.max(), two_steps), (what, err.max(), own.max(), two_steps)


# ---------------------------------------------------------------- cast points


@pytest.mark.parametrize("kind", ["exact", "tanh"])
def test_gelu_rounds_per_operation_like_jax(rng, kind):
    """`_gelu` on bf16 equals eager `jax.nn.gelu` on bf16 (which rounds after
    every operation) on all but denormal-sized elements; F.gelu, which
    rounds once, differs on about 40% of them."""
    xj, xt = _bf16_pair(rng, (200_000,), 3.0)
    want = _np(jax.nn.gelu(xj, approximate=kind == "tanh"))
    got = _np(tw._gelu(xt, kind))
    off = got != want
    assert off.mean() <= 1e-5 and np.abs(got - want)[off].max(initial=0) < 1e-30, off.mean()
    assert tw._gelu(xt.float(), kind).dtype == torch.float32


def test_dense_and_conv_add_the_bias_in_bf16(rng):
    """flax `nn.Dense` / `nn.Conv(dtype=bf16)` round the product, then add
    the bf16 bias: the feature projection and the positional conv equal
    eager flax on all but 1e-3 of the elements (f32 sum order)."""
    cfg = dataclasses.replace(tc.EmbedderConfig.tiny(), dtype="bfloat16")
    jcfg = dataclasses.replace(jc.EmbedderConfig.tiny(), dtype="bfloat16")
    x = rng.standard_normal((2, 40, 8)).astype(np.float32)
    proj = jw.FeatureProjection(jcfg)
    p = random_params(proj.init, jax.random.PRNGKey(0), x, seed=3)
    want = _np(proj.apply(p, x))
    mine = tw.FeatureProjection(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        mine.layer_norm.weight.copy_(torch.from_numpy(np.asarray(p["params"]["layer_norm"]["scale"])))
        mine.layer_norm.bias.copy_(torch.from_numpy(np.asarray(p["params"]["layer_norm"]["bias"])))
        mine.projection.weight.copy_(torch.from_numpy(np.asarray(p["params"]["projection"]["kernel"]).T))
        mine.projection.bias.copy_(torch.from_numpy(np.asarray(p["params"]["projection"]["bias"])))
        got = _np(mine(torch.from_numpy(x).transpose(1, 2)))
    assert np.mean(got != want) <= 1e-3, np.mean(got != want)

    h = jnp.asarray(rng.standard_normal((2, 40, 32)).astype(np.float32)).astype(jnp.bfloat16)
    conv = nn.Conv(32, kernel_size=(16,), padding=((8, 8),), feature_group_count=2,
                   dtype=jnp.bfloat16)
    cp = random_params(conv.init, jax.random.PRNGKey(0), h, seed=4)
    want = _np(conv.apply(cp, h))
    pos = tw.PositionalConvEmbedding(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        pos.conv.weight.copy_(torch.from_numpy(np.asarray(cp["params"]["kernel"]).transpose(2, 1, 0)))
        pos.conv.bias.copy_(torch.from_numpy(np.asarray(cp["params"]["bias"])))
        got = _np(tw._conv1d(torch.from_numpy(_np(h)).to(BF16).transpose(1, 2), pos.conv)
                  .transpose(1, 2))
    assert np.mean(got != want) <= 1e-3, np.mean(got != want)


@pytest.mark.parametrize("fused_ln", [True, False])
def test_frontend_block_dispatch_matches_jax(rng, fused_ln):
    """At 8 channels JAX never takes its LN+GELU kernel (C % 128 != 0), so
    with or without `fused_ln_gelu` a bf16 frontend layer is the unfused
    `_LNf32Stats` + `_gelu`: the port's block equals eager flax's on all but
    1e-3 of the elements (kernel D's f32 GELU would differ on ~40%)."""
    x = rng.standard_normal((2, 300, 8)).astype(np.float32)
    blk = jw.ConvLayerNormBlock(features=8, kernel=3, stride=2, use_bias=True, eps=1e-5,
                                dtype=jnp.bfloat16, fused_ln=fused_ln, fused_interpret=True)
    p = random_params(blk.init, jax.random.PRNGKey(0), x, seed=5)
    want = _np(blk.apply(p, jnp.asarray(x).astype(jnp.bfloat16)))
    cfg = dataclasses.replace(tc.EmbedderConfig.tiny(), dtype="bfloat16", fused_ln_gelu=fused_ln)
    mine = tw.ConvLayerNormBlock(8, 8, 3, 2, cfg, torch.Generator().manual_seed(0), "cpu")
    leaf = p["params"]
    with torch.no_grad():
        mine.conv.weight.copy_(torch.from_numpy(np.asarray(leaf["conv"]["kernel"]).transpose(2, 1, 0)))
        mine.conv.bias.copy_(torch.from_numpy(np.asarray(leaf["conv"]["bias"])))
        mine.layer_norm.weight.copy_(torch.from_numpy(np.asarray(leaf["layer_norm"]["scale"])))
        mine.layer_norm.bias.copy_(torch.from_numpy(np.asarray(leaf["layer_norm"]["bias"])))
        got = _np(mine(torch.from_numpy(x).to(BF16).transpose(1, 2)).transpose(1, 2))
    assert np.mean(got != want) <= 1e-3, np.mean(got != want)


def test_query_scale_rounds_to_bf16():
    """JAX multiplies q by hd^-0.5 as a weakly typed scalar, which becomes a
    bf16 constant; at XLS-R's head dim 120 that constant is not exact."""
    cfg = dataclasses.replace(tc.EmbedderConfig.tiny(), hidden_size=240, num_heads=2,
                              intermediate_size=16, dtype="bfloat16")
    layer = tw.EncoderLayer(cfg, torch.Generator().manual_seed(0), "cpu")
    q = jnp.linspace(-4, 4, 4097).astype(jnp.bfloat16)
    want = _np(q * 120**-0.5)
    np.testing.assert_array_equal(_np(torch.from_numpy(_np(q)).to(BF16) * layer.q_scale), want)
    assert layer.q_scale != 120**-0.5


# ---------------------------------------------------------------- the embedder


@pytest.fixture(scope="module")
def enc_case():
    """Weights per frontend width, the clips, and JAX's outputs by
    configuration (computed once each: the eager runs dominate the time)."""
    wav = np.random.default_rng(3).standard_normal((3, 8000)).astype(np.float32) * 0.1
    wav = np.array(j_norm(jnp.asarray(wav)))
    params = {cd: random_params(jw.Wav2Vec2Encoder(dataclasses.replace(
        jc.EmbedderConfig.tiny(), conv_dim=(cd,) * 3)).init, jax.random.PRNGKey(1),
        jnp.zeros((1, 8000)), seed=11) for cd in (8, 128)}
    cache: dict = {}

    def jax_out(cd, dtype, **kw):
        # JAX takes its LN+GELU kernel only at C % 128 == 0, and f32 is one function
        if cd % 128 or dtype == "float32":
            kw["fused_ln_gelu"] = False
        key = (cd, dtype, tuple(sorted(kw.items())))
        if key not in cache:
            cfg = dataclasses.replace(jc.EmbedderConfig.tiny(), conv_dim=(cd,) * 3, dtype=dtype,
                                      fused_interpret=kw.get("fused_attention", True), **kw)
            apply = jw.Wav2Vec2Encoder(cfg).apply
            run = jax.jit(apply) if dtype == "float32" else apply
            cache[key] = np.asarray(run(params[cd], wav))
        return cache[key]

    return wav, params, jax_out


def _port_features(params, wav, **kw):
    enc = tw.Wav2Vec2Encoder(dataclasses.replace(tc.EmbedderConfig.tiny(), **kw),
                             torch.Generator().manual_seed(0), "cpu").eval()
    load_encoder(enc, params["params"])
    with torch.no_grad():
        return enc(torch.from_numpy(wav)).numpy()


@pytest.mark.parametrize("cd", [8, 128])
@pytest.mark.parametrize("fused_ln", [True, False])
@pytest.mark.parametrize("gelu", ["exact", "tanh"])
def test_bf16_encoder_matches_eager_jax(enc_case, cd, fused_ln, gelu):
    """The bf16 embedder against JAX's bf16 (its attention and LN+GELU
    kernels in interpret mode), at the bars of the module docstring."""
    wav, params, jax_out = enc_case
    kw = dict(gelu=gelu, fused_ln_gelu=fused_ln)
    ref = jax_out(cd, "bfloat16", **kw)
    mine = _port_features(params[cd], wav, conv_dim=(cd,) * 3, dtype="bfloat16", **kw)
    _assert_bars(mine, ref, jax_out(cd, "float32", gelu=gelu), f"cd={cd}")


def test_unfused_attention_matches_jax(enc_case):
    """`fused_attention=False`: unpadded projections and the einsum order of
    `attention_reference`. f32 against jitted JAX at 5e-4 (the hidden-state
    bar); bf16 against eager JAX at the relative bars."""
    wav, params, jax_out = enc_case
    f32 = _port_features(params[8], wav, fused_attention=False)
    np.testing.assert_allclose(f32, jax_out(8, "float32", fused_attention=False), atol=5e-4)
    mine = _port_features(params[8], wav, dtype="bfloat16", fused_attention=False)
    _assert_bars(mine, jax_out(8, "bfloat16", fused_attention=False),
                 jax_out(8, "float32", fused_attention=False), "unfused attention")


# ---------------------------------------------------------------- the UNet, explain


def test_bf16_unet_matches_jax(rng):
    """bf16 convs and transposed convs with bf16 biases, f32 BatchNorm and
    leaky ReLU, skips cast before the concat, f32 sigmoid."""
    mag = rng.uniform(0, 2, (2, 64, 24)).astype(np.float32)
    jcfg = jc.UNetConfig(**TINY_UNET, dtype="bfloat16")
    variables = random_params(JUNet(jcfg).init, jax.random.PRNGKey(0), mag, seed=6)
    ref = np.asarray(_strict(JUNet(jcfg).apply, variables, jnp.asarray(mag)))
    f32 = np.asarray(jax.jit(JUNet(jc.UNetConfig(**TINY_UNET)).apply)(variables, jnp.asarray(mag)))
    model = UNetMaskDecoder(tc.UNetConfig(**TINY_UNET, dtype="bfloat16")).eval()
    load_unet(model, variables)
    with torch.no_grad():
        mine = model(torch.from_numpy(mag)).numpy()
    assert mine.dtype == np.float32
    _assert_bars(mine, ref, f32, "bf16 UNet mask")


def _jax_explain(jpipe, params, wav):
    """`ADDvisorPipeline.explain(decoder="unet")` of the JAX package, stage by
    stage: the f32 stages jitted, a bf16 UNet under `_strict`, a bf16
    embedder pass eager (their cast points). The composition is explain's
    own."""
    _, _, mag, phase = jax.jit(jpipe.spectrogram)(wav)
    if jpipe.cfg.unet.dtype == "bfloat16":
        mask = _strict(jpipe.predict_mask, params, mag)
    else:
        mask = jax.jit(jpipe.predict_mask)(params, mag)

    @jax.jit
    def resynth(mask, mag, phase):
        rel, irr = apply_mask(mask, mag, jpipe.cfg.masking)
        return jpipe.istft(*remask_complex(rel, phase)), jpipe.istft(*remask_complex(irr, phase))

    rel_wav, irr_wav = resynth(mask, mag, phase)
    classify = jpipe.classify if jpipe.cfg.embedder.dtype == "bfloat16" else jax.jit(
        jpipe.classify)
    _, probs = classify(params, jnp.concatenate([wav, rel_wav, irr_wav]))
    return mask, rel_wav, irr_wav, np.asarray(probs)


def test_entry_config_explain_matches_eager_jax(enc_case):
    """The entry point's configuration (bf16 embedder with the default
    `fused_ln_gelu=False`, f32 UNet) at tiny size: the explain's f32 stages
    at the f32 bars (mask 1e-5, waveforms 2e-4), the three probabilities at
    the relative bars against JAX's bf16 explain (its attention kernel in
    interpret mode)."""
    wav = np.random.default_rng(7).standard_normal((1, 8000)).astype(np.float32) * 0.1
    out = {}
    for dtype in ("bfloat16", "float32"):
        jpipe = JPipeline(jc.PipelineConfig(
            audio=jc.AudioConfig(clip_seconds=0.5), unet=jc.UNetConfig(**TINY_UNET),
            embedder=dataclasses.replace(jc.EmbedderConfig.tiny(), dtype=dtype,
                                         fused_interpret=True)))
        if not out:
            params = {
                "encoder": enc_case[1][8],
                "unet": random_params(jpipe.unet.init, jax.random.PRNGKey(0),
                                      jnp.zeros((1, 64, 24)), seed=2),
                "logreg": {"weight": np.random.default_rng(8).standard_normal(
                    (32, 1)).astype(np.float32) * 0.3, "bias": np.zeros(1, np.float32)},
            }
        out[dtype] = _jax_explain(jpipe, params, jnp.asarray(wav))
    pipe = ADDvisorPipeline(tc.PipelineConfig(
        audio=tc.AudioConfig(clip_seconds=0.5), unet=tc.UNetConfig(**TINY_UNET),
        embedder=dataclasses.replace(tc.EmbedderConfig.tiny(), dtype="bfloat16")), device="cpu")
    load_jax_params(pipe, params)
    mine = pipe.explain(wav)
    ref = out["bfloat16"]
    for i, (name, atol) in enumerate((("mask", 1e-5), ("relevant_wav", 2e-4),
                                      ("irrelevant_wav", 2e-4))):
        np.testing.assert_allclose(getattr(mine, name).numpy(), np.asarray(ref[i]),
                                   atol=atol, err_msg=name)
    mine_p = torch.cat([mine.probs_clean, mine.probs_relevant, mine.probs_irrelevant]).numpy()
    _assert_bars(mine_p, ref[3], out["float32"][3], "probabilities")


def test_stft_precision_default_equals_highest():
    """The JAX package's CPU path computes every STFT precision in exact
    f32; the port accepts all three and computes the same f32 transform."""
    wav = np.random.default_rng(9).standard_normal((2, 8000)).astype(np.float32) * 0.1
    outs = []
    for precision in ("default", "highest"):
        cfg = tc.PipelineConfig(audio=tc.AudioConfig(clip_seconds=0.5),
                                embedder=tc.EmbedderConfig.tiny(),
                                stft=tc.STFTConfig(precision=precision),
                                unet=tc.UNetConfig(**TINY_UNET))
        outs.append(ADDvisorPipeline(cfg, device="cpu").spectrogram(wav))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _deviation_report(n_draws: int) -> None:
    """Per embedder case of `test_bf16_encoder_matches_eager_jax`, over
    `n_draws` seeded input draws (the first is the test's): the port's mean
    and max deviation from eager JAX as multiples of JAX's own bf16-vs-f32
    deviation, and its mean deviation from jitted JAX beside jit's from
    eager; then the share of elements where `_strict` differs from eager
    `apply`, for the embedder in both GELU forms and for the bf16 UNet."""
    for cd in (8, 128):
        params = random_params(jw.Wav2Vec2Encoder(dataclasses.replace(
            jc.EmbedderConfig.tiny(), conv_dim=(cd,) * 3)).init, jax.random.PRNGKey(1),
            jnp.zeros((1, 8000)), seed=11)
        for gelu in ("exact", "tanh"):
            for fused_ln in (True, False):
                kw = dict(conv_dim=(cd,) * 3, gelu=gelu, fused_ln_gelu=fused_ln)
                rows = []
                for draw in range(n_draws):
                    wav = np.random.default_rng(3 + draw).standard_normal((3, 8000)) * 0.1
                    wav = np.array(j_norm(jnp.asarray(wav.astype(np.float32))))
                    f32 = np.asarray(jax.jit(jw.Wav2Vec2Encoder(dataclasses.replace(
                        jc.EmbedderConfig.tiny(), **kw)).apply)(params, wav))
                    apply = jw.Wav2Vec2Encoder(dataclasses.replace(
                        jc.EmbedderConfig.tiny(), dtype="bfloat16", fused_interpret=True,
                        **kw)).apply
                    ref = np.asarray(apply(params, wav))
                    jit = np.asarray(jax.jit(apply)(params, wav))
                    mine = _port_features(params, wav, dtype="bfloat16", **kw)
                    err, own = np.abs(mine - ref), np.abs(ref - f32)
                    rows.append(f"mean {err.mean() / own.mean():.3f}x max {err.max():.4g} = "
                                f"{err.max() / own.max():.3f}x (port-jit {np.abs(mine - jit).mean():.4g}, "
                                f"jit-eager {np.abs(jit - ref).mean():.4g} on "
                                f"{np.mean(jit != ref):.3f})")
                print(f"{cd} channels, {gelu}, fused_ln_gelu={fused_ln}: " + "; ".join(rows))
            strict = np.asarray(_strict(apply, params, wav))
            print(f"{cd} channels, {gelu}: _strict differs from eager on "
                  f"{np.mean(strict != np.asarray(apply(params, wav))):.4f} of the elements")
    mag = np.random.default_rng(3).uniform(0, 2, (2, 64, 24)).astype(np.float32)
    for quant in ("none", "int8"):
        unet = JUNet(jc.UNetConfig(**TINY_UNET, dtype="bfloat16", quant=quant))
        variables = random_params(unet.init, jax.random.PRNGKey(0), mag, seed=6)
        strict = np.asarray(_strict(unet.apply, variables, mag))
        print(f"bf16 UNet, quant {quant}: _strict differs from eager on "
              f"{np.mean(strict != np.asarray(unet.apply(variables, mag))):.4f} of the elements")


if __name__ == "__main__":
    # python -m tests.test_torch_bf16 [n_draws]: the deviations behind the bars
    import sys

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    _deviation_report(int(sys.argv[1]) if len(sys.argv) > 1 else 1)
