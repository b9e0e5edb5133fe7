"""PyTorch port, the rest of the encoder: the HF checkpoint import (against
a random-init transformers `Wav2Vec2Model` and bit for bit against the JAX
package's importer), the hand-written safetensors reader, the scanned
parameter layout and the "dots" remat policy, at tiny widths on the CPU."""

import collections
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from xai_audio_deepfakes_tpu import config as jc
from xai_audio_deepfakes_tpu.models import wav2vec2 as jw
from xai_audio_deepfakes_tpu.ops.normalize import zero_mean_unit_var_norm as j_norm
from tests.test_torch_models import random_params
from tests.test_torch_quant import _rel_l2
from tests.test_torch_train import check_train_step_against_jax, make_jax_params
from xai_audio_deepfakes_tpu_torch import config as tc
from xai_audio_deepfakes_tpu_torch.convert import load_encoder
from xai_audio_deepfakes_tpu_torch.models.wav2vec2 import (
    Wav2Vec2Encoder,
    load_safetensors,
    params_from_hf_dir,
    params_from_hf_state_dict,
    stack_layer_params,
)

WN = "encoder.pos_conv_embed.conv.parametrizations.weight.original"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Backward passes on several xdist workers: one intra-op thread each
    (see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hf_model():
    """A random-init transformers Wav2Vec2Model of the tiny embedder's
    geometry with one layer more than `num_layers` (so every import
    truncates), its weight-norm scale g drawn away from |v|."""
    transformers = pytest.importorskip("transformers")
    e = tc.EmbedderConfig.tiny()
    torch.manual_seed(0)
    model = transformers.Wav2Vec2Model(transformers.Wav2Vec2Config(
        hidden_size=e.hidden_size, num_hidden_layers=e.num_layers + 1,
        num_attention_heads=e.num_heads, intermediate_size=e.intermediate_size,
        conv_dim=list(e.conv_dim), conv_kernel=list(e.conv_kernel),
        conv_stride=list(e.conv_stride), num_conv_pos_embeddings=e.num_conv_pos_embeddings,
        num_conv_pos_embedding_groups=e.num_conv_pos_embedding_groups,
        do_stable_layer_norm=True, feat_extract_norm="layer", conv_bias=True,
        hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0))
    with torch.no_grad():
        g = dict(model.named_parameters())["encoder.pos_conv_embed.conv.parametrizations.weight.original0"]
        g.mul_(torch.rand(g.shape, generator=torch.Generator().manual_seed(1)) + 0.5)
    return model.eval()


@pytest.fixture(scope="module")
def hf_sd(hf_model):
    return {k: v.numpy() for k, v in hf_model.state_dict().items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}") if isinstance(v, dict) else {f"{prefix}/{k}": v})
    return out


def assert_trees_equal(got: dict, want: dict) -> None:
    got, want = _flat(got), _flat(jax.tree.map(np.asarray, want))
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert got[key].dtype == w.dtype == np.float32, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)


def test_hf_model_hidden_state_matches(hf_model, hf_sd):
    """Through `params_from_hf_state_dict` and the bridge, the port's f32
    encoder gives HF's hidden_states[output_layer] (atol 5e-4)."""
    cfg = tc.EmbedderConfig.tiny()
    enc = Wav2Vec2Encoder(cfg, torch.Generator().manual_seed(0), "cpu").eval()
    load_encoder(enc, params_from_hf_state_dict(hf_sd, cfg)["params"])
    wav = np.random.default_rng(2).standard_normal((2, 4000)).astype(np.float32)
    wav = torch.from_numpy(np.array(j_norm(jnp.asarray(wav * 0.1))))
    with torch.no_grad():
        got = enc(wav)
        want = hf_model(wav, output_hidden_states=True).hidden_states[cfg.output_layer]
    torch.testing.assert_close(got, want, atol=5e-4, rtol=0)


def _weight_g_form(sd: dict) -> dict:
    """The older weight-norm keys, `weight_g` / `weight_v`."""
    names = {f"{WN}0": "encoder.pos_conv_embed.conv.weight_g",
             f"{WN}1": "encoder.pos_conv_embed.conv.weight_v"}
    return {names.get(k, k): v for k, v in sd.items()}


@pytest.mark.parametrize("case", ["parametrizations", "weight_g", "scan_layers",
                                  "final_layer_norm", "fewer_layers_than_asked"])
def test_tree_matches_jax_importer_bit_for_bit(hf_sd, case):
    """The port's numpy tree equals JAX's `params_from_hf_state_dict`'s
    bit for bit: both weight-norm key forms (g * v / |v| over axes (0, 1)),
    truncation to num_layers from a checkpoint with one layer more, the
    stacked layout, the final LayerNorm, and a config that asks for more
    layers than the checkpoint has (min of the two)."""
    sd = _weight_g_form(hf_sd) if case == "weight_g" else hf_sd
    changes = {"scan_layers": dict(scan_layers=True),
               "final_layer_norm": dict(final_layer_norm=True),
               "fewer_layers_than_asked": dict(num_layers=6)}.get(case, {})
    got = params_from_hf_state_dict(sd, dataclasses.replace(tc.EmbedderConfig.tiny(), **changes))
    want = jw.params_from_hf_state_dict(sd, dataclasses.replace(jc.EmbedderConfig.tiny(), **changes))
    assert_trees_equal(got, want)
    p = got["params"]
    n = {"fewer_layers_than_asked": 4}.get(case, 3)
    if case == "scan_layers":
        assert p["layers"]["layer"]["ffn_in"]["kernel"].shape == (n, 32, 64)
        unrolled = params_from_hf_state_dict(sd, tc.EmbedderConfig.tiny())["params"]
        assert_trees_equal({"params": stack_layer_params(unrolled, n)}, want)
    else:
        assert sorted(k for k in p if k.startswith("layer_")) == [f"layer_{i}" for i in range(n)]
    assert ("final_ln" in p) == (case == "final_layer_norm")


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_hf_dir_matches_jax_importer(hf_sd, tmp_path, fmt):
    """`params_from_hf_dir` on a checkpoint whose keys carry the
    `wav2vec2.` prefix, as `model.safetensors` (the port's own reader) or
    `pytorch_model.bin` (`weights_only=True`): JAX's tree, bit for bit."""
    st = pytest.importorskip("safetensors.torch")
    sd = {f"wav2vec2.{k}": torch.from_numpy(v) for k, v in _weight_g_form(hf_sd).items()}
    if fmt == "safetensors":
        st.save_file(sd, str(tmp_path / "model.safetensors"))
    else:
        torch.save(sd, tmp_path / "pytorch_model.bin")
    got = params_from_hf_dir(str(tmp_path), tc.EmbedderConfig.tiny())
    want = jw.params_from_hf_dir(str(tmp_path), jc.EmbedderConfig.tiny())
    assert_trees_equal(got, want)


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16"])
def test_safetensors_reader_matches_library(tmp_path, dtype):
    """`load_safetensors` against the safetensors package on the same file,
    tensors of several ranks (a scalar and an odd-length vector included)
    and a metadata block: the same names, shapes and values, bit for bit.
    numpy has no bfloat16, so BF16 is held against the package's torch
    loader, widened to f32 (exact)."""
    st = pytest.importorskip("safetensors.torch")
    tdt = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(3)
    tensors = {name: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(tdt)
               for name, shape in (("a.weight", (3, 5)), ("b", (7,)), ("c", (2, 3, 4)),
                                   ("scalar", ()))}
    path = str(tmp_path / "x.safetensors")
    st.save_file(tensors, path, metadata={"format": "pt"})
    got = load_safetensors(path)
    if dtype == "BF16":
        want = {k: v.float().numpy() for k, v in st.load_file(path).items()}
    else:
        want = pytest.importorskip("safetensors.numpy").load_file(path)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_safetensors_reader_refuses_other_dtypes(tmp_path):
    """A tensor of a dtype the reader does not take (I64 here) raises and
    names the dtype; the file is written by hand, so no package is needed."""
    data = np.arange(3, dtype="<i8").tobytes()
    head = json.dumps({"n": {"dtype": "I64", "shape": [3], "data_offsets": [0, len(data)]}})
    head = head.encode() + b" " * (-len(head) % 8)
    path = tmp_path / "x.safetensors"
    path.write_bytes(len(head).to_bytes(8, "little") + head + data)
    with pytest.raises(ValueError, match="unsupported dtype I64"):
        load_safetensors(str(path))


# ---------------------------------------------------------------------------
# scan_layers: the stacked layout
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scanned():
    """A JAX encoder built with scan_layers=True (its num_layers 3 stacked,
    its readout the output of layer 2), random numpy weights in its stacked
    tree, and normalised clips."""
    jcfg = dataclasses.replace(jc.EmbedderConfig.tiny(), scan_layers=True)
    params = random_params(jw.Wav2Vec2Encoder(jcfg).init, jax.random.PRNGKey(0),
                           jnp.zeros((1, 4000)), seed=11)
    assert params["params"]["layers"]["layer"]["q_proj"]["kernel"].shape[0] == 3
    wav = np.random.default_rng(4).standard_normal((2, 4000)).astype(np.float32) * 0.1
    return jcfg, params, np.array(j_norm(jnp.asarray(wav)))


def _port(params, **kw):
    cfg = dataclasses.replace(tc.EmbedderConfig.tiny(), scan_layers=True, **kw)
    enc = Wav2Vec2Encoder(cfg, torch.Generator().manual_seed(0), "cpu").eval()
    load_encoder(enc, params["params"])
    return enc


def test_scan_layers_features_match_jax(scanned):
    """The stacked tree through the bridge gives JAX's scanned encoder's
    features at the f32 encoder bar (5e-4)."""
    jcfg, params, wav = scanned
    want = np.asarray(jax.jit(jw.Wav2Vec2Encoder(jcfg).apply)(params, wav))
    with torch.no_grad():
        got = _port(params)(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_scan_layers_static_int8_scales_match_jax(scanned):
    """int8-static with the stacked per-layer scales JAX's scanned encoder
    calibrates ({site: [3, C]}): the port's features match JAX's at 1/10 of
    its int8-static-vs-f32 relative L2, as the unrolled int8 tests do. The
    einsum attention on both sides, whose `ctx` site is H wide on the CPU
    (the head-padded one needs JAX's interpret-mode kernel)."""
    jcfg, params, wav = scanned
    qcfg = dataclasses.replace(jcfg, quant="int8-static", fused_attention=False)
    enc = jw.Wav2Vec2Encoder(qcfg)
    _, absmax = jax.jit(lambda p, w: enc.apply(p, w, calibrate=True))(params, wav)
    scales = {k: np.asarray(a)[:, 1, :] / np.float32(127.0) for k, a in absmax.items()}
    assert scales["qkv"].shape == (3, 32)
    want = np.asarray(jax.jit(enc.apply)(params, wav, act_scales=scales))
    f32 = np.asarray(jax.jit(jw.Wav2Vec2Encoder(jcfg).apply)(params, wav))
    with torch.no_grad():
        got = _port(params, quant="int8-static", fused_attention=False)(
            torch.from_numpy(wav), act_scales={k: torch.from_numpy(v) for k, v in scales.items()})
    assert _rel_l2(got.numpy(), want) <= 0.1 * _rel_l2(want, f32), (
        _rel_l2(got.numpy(), want), _rel_l2(want, f32))


# ---------------------------------------------------------------------------
# remat_policy="dots"
# ---------------------------------------------------------------------------


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def _encoder_backward(remat: str | None):
    """Input gradient of a tiny f32 encoder's summed squared features, and
    the aten ops its backward pass ran."""
    kw = {} if remat is None else dict(remat=True, remat_policy=remat)
    enc = Wav2Vec2Encoder(dataclasses.replace(tc.EmbedderConfig.tiny(), **kw),
                          torch.Generator().manual_seed(1), "cpu")
    enc.requires_grad_(False)
    wav = torch.randn(2, 4000, generator=torch.Generator().manual_seed(0)).requires_grad_()
    loss = (enc(wav) ** 2).sum()
    with _OpCounter() as ops:
        loss.backward()
    return wav.grad, ops.counts


def test_dots_remat_recomputes_no_product():
    """The "dots" policy's input gradient equals the unremat one (1e-6),
    and its backward pass recomputes no product (as many mm / addmm / bmm
    as without remat, where "full" runs more) while it does recompute the
    LayerNorms and GELUs (as many forward LayerNorms as "full", none
    without remat)."""
    none_g, none = _encoder_backward(None)
    full_g, full = _encoder_backward("full")
    dots_g, dots = _encoder_backward("dots")
    torch.testing.assert_close(dots_g, none_g, atol=1e-6, rtol=0)
    torch.testing.assert_close(full_g, none_g, atol=1e-6, rtol=0)
    products = ("mm", "addmm", "bmm")
    assert sum(full[k] for k in products) > sum(none[k] for k in products)
    assert {k: dots[k] for k in products} == {k: none[k] for k in products}
    assert none["native_layer_norm"] == 0
    assert dots["native_layer_norm"] == full["native_layer_norm"] == 2 * 2  # 2 layers x 2 LNs
    assert dots["gelu"] == full["gelu"] > 0 == none["gelu"]


def test_dots_train_step_matches_jax():
    """One LMAC training step with remat_policy="dots" on both sides
    against JAX's, at the bars of `test_train_step_matches_jax`."""
    check_train_step_against_jax(make_jax_params(),
                                 embedder=dict(remat=True, remat_policy="dots"))
