"""PyTorch port, int8 serving: `ops/quant.py` against the JAX package's
`ops/quant.py` on the same arrays, and the int8 embedder, int8-static
calibration, the int8 frontend (`quant_conv`) and the int8 UNet
(`UNetConfig.quant`) against the JAX modules on the same weights and scales,
on the CPU at tiny geometry.

Bars: int8 values and scales bit-equal; products rtol 1e-6 (the int32 sums
are exact on both sides, and the rescale is the same f32 arithmetic). A model
output's port-vs-JAX relative L2 is at most 1/10 of JAX's own int8-vs-f32
relative L2 on the same inputs: what is left is the float arithmetic around
the products, whose f32 rounding can move a value across a quantization step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xai_audio_deepfakes_tpu import config as jc
from xai_audio_deepfakes_tpu.models.unet import UNetMaskDecoder as JUNet
from xai_audio_deepfakes_tpu.models.wav2vec2 import Wav2Vec2Encoder as JEncoder
from xai_audio_deepfakes_tpu.ops import quant as jq
from xai_audio_deepfakes_tpu.ops.normalize import zero_mean_unit_var_norm as j_norm
from xai_audio_deepfakes_tpu.pipeline.core import ADDvisorPipeline as JPipeline
from tests.test_torch_bf16 import _jax_explain, _strict
from tests.test_torch_models import TINY_UNET, random_params
from xai_audio_deepfakes_tpu_torch import config as tc
from xai_audio_deepfakes_tpu_torch.convert import (
    load_encoder,
    load_jax_params,
    load_quant_scales,
    load_unet,
)
from xai_audio_deepfakes_tpu_torch.models.unet import UNetMaskDecoder
from xai_audio_deepfakes_tpu_torch.models.wav2vec2 import (
    PositionalConvEmbedding,
    Wav2Vec2Encoder,
)
from xai_audio_deepfakes_tpu_torch.ops import quant as tq
from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small graphs: torch's intra-op pool only adds overhead here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---------------------------------------------------------------- ops/quant


@pytest.mark.parametrize("shape,axis", [((3, 5, 16), -1), ((3, 5, 16), (1, 2)),
                                        ((2, 4, 6, 3), (1, 2, 3)), ((4, 16), 0)])
def test_quantize_symmetric_bit_equal(rng, shape, axis):
    """int8 values and scales bit-equal, a zero row (the 1e-12 floor) and
    exact halves (round half to even) included."""
    x = rng.standard_normal(shape).astype(np.float32) * 3
    x.reshape(-1)[: shape[-1]] = 0.0
    x.reshape(-1)[-4:] = [0.5, 1.5, -2.5, 127.0]
    q_j, s_j = jq.quantize_symmetric(jnp.asarray(x), axis)
    q_t, s_t = tq.quantize_symmetric(torch.from_numpy(x), axis)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


@pytest.mark.parametrize("m,k,n", [(5, 15, 3), (16, 297, 4), (40, 64, 24), (7, 32, 33)])
def test_matmuls_match_jax(rng, m, k, n):
    """int8_matmul, int8_matmul_prequant and int8_matmul_static against the
    JAX package's at shapes where `torch._int_mm`'s CUDA limits make
    `int_mm` pad (M <= 16, K and N not multiples of 8): rtol 1e-6."""
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)  # JAX layout [K, N]
    wt = torch.from_numpy(np.ascontiguousarray(w.T))
    np.testing.assert_allclose(tq.int8_matmul(torch.from_numpy(x), wt).numpy(),
                               np.asarray(jq.int8_matmul(jnp.asarray(x), jnp.asarray(w))),
                               rtol=1e-6, atol=1e-7)
    s_act = np.abs(x).max(axis=0) / 127.0 + 1e-3
    xq = np.clip(np.round(x / s_act), -127, 127).astype(np.int8)
    np.testing.assert_allclose(
        tq.int8_matmul_static(torch.from_numpy(xq), torch.from_numpy(s_act), wt).numpy(),
        np.asarray(jq.int8_matmul_static(jnp.asarray(xq), jnp.asarray(s_act), jnp.asarray(w))),
        rtol=1e-6, atol=1e-7)


def test_int_mm_pads_exactly_and_sums_in_int32():
    """`int_mm` equals the exact integer product at padded shapes, and stays
    exact where an f32 sum would not: K = 120 * 128 (the positional conv's),
    with products of 100 to 127 squared, sums far beyond 2^24."""
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (5, 15), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (3, 15), generator=g, dtype=torch.int8)
    torch.testing.assert_close(tq.int_mm(a, b), (a.long() @ b.long().T).int(), rtol=0, atol=0)
    k = 120 * 128
    a = torch.randint(100, 128, (17, k), generator=g, dtype=torch.int8)
    b = torch.randint(100, 128, (8, k), generator=g, dtype=torch.int8)
    want = (a.long() @ b.long().T)
    assert int(want.max()) > 2**24
    torch.testing.assert_close(tq.int_mm(a, b).long(), want, rtol=0, atol=0)
    assert not torch.equal((a.float() @ b.float().T).long(), want)  # what f32 would give


@pytest.mark.parametrize("k,stride,length", [(3, 2, 33), (2, 2, 20), (10, 5, 64)])
def test_int8_conv1d_matches_jax(rng, k, stride, length):
    x = rng.standard_normal((2, length, 12)).astype(np.float32)  # JAX NHC
    w = rng.standard_normal((k, 12, 8)).astype(np.float32) / np.sqrt(12 * k)  # HIO
    want = np.asarray(jq.int8_conv1d(jnp.asarray(x), jnp.asarray(w), stride=stride))
    got = tq.int8_conv1d(torch.from_numpy(x).transpose(1, 2), _t(w.transpose(2, 1, 0)), stride)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cin,kernel,stride,pad,dil", [
    (1, (5, 3), (2, 1), (2, 1), (1, 1)),   # UNet e1: K = 15
    (33, (3, 3), (1, 1), (1, 1), (1, 1)),  # UNet d1: K = 297
    (8, (3, 3), (2, 2), (1, 1), (1, 1)),
    (8, (3, 3), (1, 1), (4, 4), (4, 4)),   # the dilated bottleneck
])
def test_int8_conv2d_matches_jax(rng, cin, kernel, stride, pad, dil):
    x = rng.standard_normal((2, 12, 10, cin)).astype(np.float32)  # NHWC
    w = rng.standard_normal((*kernel, cin, 4)).astype(np.float32) / np.sqrt(cin * 9)  # HWIO
    want = np.asarray(jq.int8_conv2d(jnp.asarray(x), jnp.asarray(w), stride,
                                     ((pad[0], pad[0]), (pad[1], pad[1])), dil))
    got = tq.int8_conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), _t(w.transpose(3, 2, 0, 1)),
                         stride, pad, dil)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_int8_posconv_batch_independent(rng):
    """A clip's int8 positional-conv output does not depend on its batch
    neighbours (per-sample activation scale), beside a neighbour 300x
    louder: the int8 conv bitwise; after the f32 GELU to 1e-6, because
    PyTorch's CPU GELU rounds an element by its position in the vector
    loop, which the batch size moves (a shared scale would move the output
    by a quantization step, ~1e-2)."""
    cfg = dataclasses.replace(tc.EmbedderConfig.tiny(), quant="int8")
    mod = PositionalConvEmbedding(cfg, torch.Generator().manual_seed(0), "cpu")
    a = torch.from_numpy(rng.standard_normal((1, 12, cfg.hidden_size)).astype(np.float32))
    loud = torch.from_numpy(rng.standard_normal((1, 12, cfg.hidden_size)).astype(np.float32)) * 300
    both = torch.cat([a, loud])
    with torch.no_grad():
        torch.testing.assert_close(mod._int8(a), mod._int8(both)[:1], rtol=0, atol=0)
        torch.testing.assert_close(mod(a), mod(both)[:1], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- the embedder


def _encoder_params(conv_dim):
    cfg = dataclasses.replace(jc.EmbedderConfig.tiny(), conv_dim=conv_dim)
    return random_params(JEncoder(cfg).init, jax.random.PRNGKey(1), jnp.zeros((1, 4000)), seed=21)


@pytest.fixture(scope="module")
def enc_params():
    return {8: _encoder_params((8, 8, 8)), 128: _encoder_params((128, 128, 128))}


@pytest.fixture(scope="module")
def enc_wav():
    wav = np.random.default_rng(5).standard_normal((4, 4000)).astype(np.float32) * 0.1
    return np.array(j_norm(jnp.asarray(wav)))


def _port_encoder(params, **kw):
    enc = Wav2Vec2Encoder(dataclasses.replace(tc.EmbedderConfig.tiny(), **kw),
                          torch.Generator().manual_seed(0), "cpu").eval()
    load_encoder(enc, params["params"])
    return enc


@pytest.mark.parametrize("kw", [
    dict(quant="int8"),
    dict(quant="int8", fused_attention=False),
    dict(quant="int8", gelu="tanh"),
    dict(quant="int8", quant_conv="int8", conv_dim=(128, 128, 128)),
], ids=["int8", "int8-unfused-attention", "int8-tanh", "quant_conv"])
def test_int8_encoder_matches_jax(enc_params, enc_wav, kw):
    """Dynamic int8 features (f32 compute dtype) against JAX: relative L2
    <= 1/10 of JAX's int8-vs-f32. JAX runs its einsum attention: in f32 it
    differs from kernel A's order by rounding only, and per-token scales of
    the head-padded context equal those of the unpadded one (the pad lanes
    are zeros)."""
    params = enc_params[kw.get("conv_dim", (8,))[0]]
    jcfg = dataclasses.replace(jc.EmbedderConfig.tiny(), **kw)
    ref = np.asarray(jax.jit(JEncoder(jcfg).apply)(params, enc_wav))
    f32 = np.asarray(jax.jit(JEncoder(dataclasses.replace(
        jcfg, quant="none", quant_conv="none")).apply)(params, enc_wav))
    with torch.no_grad():
        out = _port_encoder(params, **kw)(torch.from_numpy(enc_wav)).numpy()
    own = _rel_l2(ref, f32)
    assert _rel_l2(out, ref) <= 0.1 * own, (_rel_l2(out, ref), own)


@pytest.mark.parametrize("fused_attention", [True, False])
def test_calibrate_and_static_int8_match_jax(enc_params, enc_wav, fused_attention):
    """`calibrate_quant` (p999, full batches of 2 of 4 clips) gives JAX's
    scales, the `ctx` site 2 * 128 wide with fused attention and 32 wide
    without (relative L2 1e-5 per site: both sides take the statistics of
    f32 activations); int8-static features served with JAX's scales, loaded
    through the bridge, match JAX at 1/10 of its int8-static-vs-f32
    deviation; uncalibrated int8-static equals dynamic int8."""
    params = enc_params[8]
    jcfg = dataclasses.replace(jc.EmbedderConfig.tiny(), quant="int8-static",
                               fused_attention=fused_attention,
                               fused_interpret=fused_attention)
    jpipe = JPipeline(jc.PipelineConfig(embedder=jcfg))
    raw = np.array(enc_wav)  # calibrate_quant normalises its input itself
    calibrated = jpipe.calibrate_quant({"encoder": params}, jnp.asarray(raw), batch_size=2)
    j_scales = jax.tree.map(np.asarray, calibrated["quant_scales"])

    def port(quant):
        cfg = tc.PipelineConfig(embedder=dataclasses.replace(
            tc.EmbedderConfig.tiny(), quant=quant, fused_attention=fused_attention))
        pipe = ADDvisorPipeline(cfg, device="cpu")
        load_encoder(pipe.encoder, params["params"])
        return pipe

    pipe = port("int8-static")
    np.testing.assert_array_equal(pipe.features(raw).numpy(), port("int8").features(raw).numpy())
    t_scales = pipe.calibrate_quant(raw, batch_size=2)
    width = {"qkv": 32, "ctx": 256 if fused_attention else 32, "ffn_in": 32, "ffn_out": 64}
    for site, want in j_scales.items():
        assert t_scales[site].shape == want.shape == (2, width[site])
        assert _rel_l2(t_scales[site].numpy(), want) <= 1e-5, site

    load_quant_scales(pipe, j_scales)
    served = pipe.features(raw).numpy()
    norm = j_norm(jnp.asarray(raw))
    ref = np.asarray(jax.jit(JEncoder(jcfg).apply)(params, norm, act_scales=j_scales))
    f32 = np.asarray(jax.jit(JEncoder(dataclasses.replace(jcfg, quant="none")).apply)(
        params, norm))
    assert _rel_l2(served, ref) <= 0.1 * _rel_l2(ref, f32), (_rel_l2(served, ref),
                                                               _rel_l2(ref, f32))


def test_static_fold_is_computed_once_per_set_of_scales(enc_params, enc_wav):
    """The int8-static weight fold is kept across calls (each call takes a
    new view of its layer's row of `quant_scales`) and recomputed when the
    scales are replaced or the weight changes in place."""
    cfg = tc.PipelineConfig(embedder=dataclasses.replace(tc.EmbedderConfig.tiny(),
                                                         quant="int8-static"))
    pipe = ADDvisorPipeline(cfg, device="cpu")
    load_encoder(pipe.encoder, enc_params[8]["params"])
    dense = pipe.encoder.layers[0].ffn_in
    fold = lambda: dense.__dict__["_derived_cache"]["static"][1]  # noqa: E731
    pipe.calibrate_quant(enc_wav, batch_size=2)
    first = pipe.features(enc_wav)
    kept = fold()
    again = pipe.features(enc_wav)
    assert fold() is kept
    torch.testing.assert_close(again, first, rtol=0, atol=0)
    pipe.quant_scales = {k: v * 2 for k, v in pipe.quant_scales.items()}
    pipe.features(enc_wav)
    assert fold() is not kept
    kept = fold()
    with torch.no_grad():
        dense.weight.mul_(0.5)
    pipe.features(enc_wav)
    assert fold() is not kept


# ---------------------------------------------------------------- the UNet


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_unet_matches_jax(rng, dtype):
    """UNetConfig.quant="int8" (ConvBlock and bottleneck convs int8, the
    transposed convs and the mask head float): mask relative L2 <= 1/10 of
    JAX's int8-vs-float; in training mode the port's UNet takes the float
    path, as the JAX decoder ignores quant under `train`."""
    mag = rng.uniform(0, 2, (2, 64, 24)).astype(np.float32)
    jcfg = jc.UNetConfig(**TINY_UNET, dtype=dtype, quant="int8")
    variables = random_params(JUNet(jcfg).init, jax.random.PRNGKey(0), mag, seed=4)
    # bf16 keeps the source's roundings under `_strict` (eager's result)
    run = (lambda f, *a: _strict(f, *a)) if dtype == "bfloat16" else (
        lambda f, *a: jax.jit(f)(*a))
    ref = np.asarray(run(JUNet(jcfg).apply, variables, jnp.asarray(mag)))
    flt = np.asarray(run(JUNet(dataclasses.replace(jcfg, quant="none")).apply,
                         variables, jnp.asarray(mag)))
    model = UNetMaskDecoder(tc.UNetConfig(**TINY_UNET, dtype=dtype, quant="int8")).eval()
    load_unet(model, variables)
    with torch.no_grad():
        out = model(torch.from_numpy(mag)).numpy()
        trained = model.train()(torch.from_numpy(mag))
        model_f = UNetMaskDecoder(tc.UNetConfig(**TINY_UNET, dtype=dtype)).train()
        load_unet(model_f, variables)
        torch.testing.assert_close(trained, model_f(torch.from_numpy(mag)), rtol=0, atol=0)
    assert _rel_l2(out, ref) <= 0.1 * _rel_l2(ref, flt), (_rel_l2(out, ref), _rel_l2(ref, flt))


# ---------------------------------------------------------------- served probabilities


@pytest.mark.parametrize("quant", ["int8", "int8-static"])
def test_bench_config_explain_matches_jax(enc_params, quant):
    """`bench.py`'s default configuration at tiny size (bf16 embedder, int8,
    tanh GELU, bf16 UNet), and the same with int8-static on JAX's calibrated
    scales: the served probabilities' relative L2 against JAX's explain
    (`_jax_explain`: the embedder eager, the bf16 UNet under `_strict`) is
    at most 1/10 of JAX's own int8-vs-f32 (no quant, f32) relative L2, and
    the bf16 mask stays within 1e-2 of JAX's (a bf16 step near 1)."""
    wav = np.random.default_rng(12).standard_normal((2, 8000)).astype(np.float32) * 0.1

    def configs(mod, **emb):
        return mod.PipelineConfig(
            audio=mod.AudioConfig(clip_seconds=0.5),
            unet=mod.UNetConfig(**TINY_UNET, dtype=emb.pop("unet_dtype")),
            embedder=dataclasses.replace(mod.EmbedderConfig.tiny(), **emb))

    bench = dict(dtype="bfloat16", quant=quant, gelu="tanh", unet_dtype="bfloat16")
    jpipe = JPipeline(configs(jc, fused_interpret=True, **bench))
    params = {
        "encoder": enc_params[8],
        "unet": random_params(jpipe.unet.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 64, 24)), seed=7),
        "logreg": {"weight": np.random.default_rng(8).standard_normal(
            (32, 1)).astype(np.float32) * 0.3, "bias": np.zeros(1, np.float32)},
    }
    if quant == "int8-static":
        calib = np.random.default_rng(13).standard_normal((4, 8000)).astype(np.float32) * 0.1
        params = jpipe.calibrate_quant(params, jnp.asarray(calib), batch_size=2)
        params["quant_scales"] = jax.tree.map(np.asarray, params["quant_scales"])
    mask, _, _, ref = _jax_explain(jpipe, params, jnp.asarray(wav))
    f32 = _jax_explain(JPipeline(configs(jc, unet_dtype="float32")), params,
                       jnp.asarray(wav))[3]

    pipe = ADDvisorPipeline(configs(tc, **bench), device="cpu")
    load_jax_params(pipe, params)
    mine = pipe.explain(wav)
    got = torch.cat([mine.probs_clean, mine.probs_relevant, mine.probs_irrelevant]).numpy()
    assert _rel_l2(got, ref) <= 0.1 * _rel_l2(ref, f32), (_rel_l2(got, ref), _rel_l2(ref, f32))
    np.testing.assert_allclose(mine.mask.numpy(), np.asarray(mask), atol=1e-2)
