"""PyTorch port, `reference_draw.py`: the JAX package's
`init_params(PRNGKey(seed))` drawn again without JAX, held against jax and
flax.

Bars: keys and random bits equal jax's exactly; `uniform` exactly; the
floats of `truncated_normal`, `lecun_normal` and the whole tree within
4 f32 ulps of each element, zeros and ones exact (the replay follows XLA's
CPU erfinv, log1p and log operation by operation and is in fact equal on
every draw here; the bar leaves room for XLA's rounding elsewhere). The
seed-0 anyband corpus's bands equal the record's
(`docs/closed_loop_anyband/closed_loop.json`).

    python -m tests.test_torch_reference_draw --fingerprints PATH

draws the JAX package's `init_params(PRNGKey(0))` at the anyband
protocol's configuration (full width, about 1.7 GB, a few minutes on the
CPU), writes each leaf's fingerprint (shape, sum, sum of squares, first 4
values) to PATH, and prints the replay's largest ulp distance from it;
`chip_smoke.py` holds the replay on the card against that file
(`tests/reference_draw_fingerprints.json`).
"""

import dataclasses
import json
import sys
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xai_audio_deepfakes_tpu.config import AudioConfig as JAudio
from xai_audio_deepfakes_tpu.config import EmbedderConfig as JEmbedder
from xai_audio_deepfakes_tpu.config import PipelineConfig as JPipelineConfig
from xai_audio_deepfakes_tpu.config import UNetConfig as JUNet
from xai_audio_deepfakes_tpu.pipeline.core import ADDvisorPipeline as JaxPipeline
from xai_audio_deepfakes_tpu_torch import config as tc
from xai_audio_deepfakes_tpu_torch import reference_draw as rd
from xai_audio_deepfakes_tpu_torch.data.synthetic import draw_anyband

ROOT = Path(__file__).resolve().parent.parent
ULPS = 4
PROTOCOL_EMBEDDER = dict(dtype="bfloat16", scan_layers=True, remat=True, remat_policy="dots")


def ulps(a, b) -> np.ndarray:
    """Elementwise distance in f32 ulps (0 between +0 and -0)."""
    ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    ia, ib = (np.where(i < 0, -(i & 0x7FFFFFFF), i) for i in (ia, ib))
    return np.abs(ia - ib)


def leaves(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, (*prefix, k))
        else:
            yield (*prefix, k), np.asarray(v)


# ---------------------------------------------------------------------------
# jax.random
# ---------------------------------------------------------------------------

SEEDS = [0, 1, 42, 2**31 + 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    mine = rd.prng_key(seed)
    assert tuple(int(v) for v in np.asarray(key)) == mine
    for num in (2, 4, 9):
        theirs = [tuple(int(v) for v in k) for k in np.asarray(jax.random.split(key, num))]
        assert theirs == rd.split(mine, num)
    for data in (0, 1, 0x9E3779B9, 0xFFFFFFFF):
        theirs = np.asarray(jax.random.fold_in(key, jnp.uint32(data)))
        assert tuple(int(v) for v in theirs) == rd.fold_in(mine, data)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (33, 65)])
def test_bits_and_uniform_equal_jax(seed, shape):
    key, mine = jax.random.PRNGKey(seed), rd.prng_key(seed)
    n = int(np.prod(shape))
    bits = np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64).reshape(-1)
    assert np.array_equal(bits, rd.random_bits(mine, n).numpy())
    # a chunk starting inside the array
    assert np.array_equal(bits[n // 3:], rd.random_bits(mine, n - n // 3, n // 3).numpy())
    u = np.asarray(jax.random.uniform(key, shape, jnp.float32, -0.7, 2.5))
    assert np.array_equal(u.view(np.int32), rd.uniform(mine, shape, -0.7, 2.5).numpy().view(np.int32))


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_truncated_normal_within_ulps(seed):
    shape = (200_000,)
    theirs = np.asarray(jax.random.truncated_normal(jax.random.PRNGKey(seed), -2.0, 2.0, shape,
                                                    jnp.float32))
    mine = rd.truncated_normal(rd.prng_key(seed), shape).numpy()
    d = ulps(theirs, mine)
    assert d.max() <= ULPS, d.max()
    assert np.mean(d == 0) > 0.999


@pytest.mark.parametrize("shape", [(64, 48), (3, 3, 17, 40), (128, 12, 48), (10, 1, 8)])
def test_lecun_normal_within_ulps(shape, monkeypatch):
    monkeypatch.setattr(rd, "CHUNK", 1000)  # several chunks per leaf
    key = jax.random.PRNGKey(5)
    theirs = np.asarray(nn.initializers.lecun_normal()(key, shape, jnp.float32))
    mine = rd.lecun_normal(rd.prng_key(5), shape).numpy()
    assert ulps(theirs, mine).max() <= ULPS


# ---------------------------------------------------------------------------
# flax's keys
# ---------------------------------------------------------------------------


class _Inner(nn.Module):
    @nn.compact
    def __call__(self, x):
        return nn.Dense(5, name="proj")(nn.LayerNorm(name="norm")(x))


class _TwoModules(nn.Module):
    @nn.compact
    def __call__(self, x):
        x = nn.Dense(6, name="first")(x)
        return _Inner(name="inner")(x)


class _ScanBody(nn.Module):
    @nn.compact
    def __call__(self, x, _):
        return nn.Dense(x.shape[-1], name="dense")(x), None


class _Scanned(nn.Module):
    @nn.compact
    def __call__(self, x):
        return nn.scan(_ScanBody, variable_axes={"params": 0}, split_rngs={"params": True},
                       length=3)(name="stack")(x, None)[0]


def test_flax_names_fold_into_the_key():
    params = _TwoModules().init(jax.random.PRNGKey(3), jnp.zeros((1, 4)))["params"]
    key = rd.prng_key(3)
    for path, shape in ((("first",), (4, 6)), (("inner", "proj"), (6, 5))):
        theirs = params[path[0]] if len(path) == 1 else params[path[0]][path[1]]
        mine = rd.lecun_normal(rd.flax_param_key(key, path, 1), shape).numpy()
        assert ulps(theirs["kernel"], mine).max() <= ULPS
    assert np.array_equal(params["inner"]["norm"]["scale"], np.ones(6, np.float32))


def test_scanned_layers_take_split_keys():
    params = _Scanned().init(jax.random.PRNGKey(7), jnp.zeros((1, 8)))["params"]
    theirs = np.asarray(params["stack"]["dense"]["kernel"])
    layer_keys = rd.split(rd.prng_key(7), 3)
    for i in range(3):
        key = rd.flax_param_key(layer_keys[i], ("stack", "dense"), rd.SCANNED_COUNT)
        assert ulps(theirs[i], rd.lecun_normal(key, (8, 8)).numpy()).max() <= ULPS


# ---------------------------------------------------------------------------
# the whole tree at tiny width
# ---------------------------------------------------------------------------


def _configs(scan: bool):
    emb = {**PROTOCOL_EMBEDDER, "scan_layers": scan, "remat": scan}
    unet = dict(freq_bins=64, frames=24, base_channels=4)
    jcfg = JPipelineConfig(audio=JAudio(clip_seconds=0.5),
                           embedder=dataclasses.replace(JEmbedder.tiny(), **emb), unet=JUNet(**unet))
    tcfg = tc.PipelineConfig(audio=tc.AudioConfig(clip_seconds=0.5),
                             embedder=dataclasses.replace(tc.EmbedderConfig.tiny(), **emb),
                             unet=tc.UNetConfig(**unet))
    return jcfg, tcfg


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unrolled"])
def test_tree_equals_init_params(scan):
    """Every leaf of the encoder, UNet (parameters and running statistics)
    and LogReg subtrees of `init_params(PRNGKey(0))`, at a tiny width with
    the protocol's switches; unrolled, the encoder's subtree, which
    `init_params` draws from its first key."""
    jcfg, tcfg = _configs(scan)
    jpipe = JaxPipeline(jcfg)
    if scan:
        theirs = jax.jit(jpipe.init_params)(jax.random.PRNGKey(0))
        theirs = {sub: theirs[sub] for sub in ("encoder", "unet", "logreg")}
    else:
        k_enc = jax.random.split(jax.random.PRNGKey(0), 4)[0]
        wav = jnp.zeros((1, jcfg.audio.num_samples), jnp.float32)
        theirs = {"encoder": jax.jit(jpipe.encoder.init)(k_enc, wav)}
    mine = rd.jax_init_params(tcfg, 0, device="cpu")
    for sub in theirs:
        t, m = dict(leaves(theirs[sub])), dict(leaves(mine[sub]))
        assert set(t) == set(m), set(t) ^ set(m)
        for path, a in t.items():
            assert a.shape == m[path].shape and m[path].dtype == np.float32, path
            d = ulps(a, m[path])
            assert d.max() <= ULPS, (path, d.max())
            if np.all((a == 0) | (a == 1)):  # zeros and ones exactly
                assert np.array_equal(a, m[path]), path


def test_replay_loads_into_the_pipeline():
    """The replayed tree fits `convert.load_jax_params` as it stands."""
    from xai_audio_deepfakes_tpu_torch.convert import load_jax_params
    from xai_audio_deepfakes_tpu_torch.pipeline.core import ADDvisorPipeline

    _, tcfg = _configs(True)
    pipe = ADDvisorPipeline(tcfg, device="cpu", seed=1)
    params = rd.jax_init_params(tcfg, 0, device="cpu")
    load_jax_params(pipe, params)
    k = params["unet"]["params"]["mask_head"]["kernel"]  # HWIO -> OIHW
    assert np.array_equal(pipe.unet.mask_head[0].weight.detach().numpy(), k.transpose(3, 2, 0, 1))


def test_seed0_anyband_bands_equal_the_record():
    """The protocol's seed-0 corpora (128 training, 64 evaluation clips)
    draw the record's evaluation bands: the port's numpy draws are the
    JAX package's."""
    record = json.loads((ROOT / "docs/closed_loop_anyband/closed_loop.json").read_text())
    rng = np.random.default_rng(0)
    draw_anyband(rng, 128, 80000, 16000, noise_rms=1.0)
    _, _, bands = draw_anyband(rng, 64, 80000, 16000, noise_rms=1.0)
    assert bands.tolist() == record["eval_bands_hz"]


# ---------------------------------------------------------------------------
# the full-width fingerprints
# ---------------------------------------------------------------------------


def fingerprint(a: np.ndarray) -> dict:
    flat = np.asarray(a, np.float32).reshape(-1)
    f64 = flat.astype(np.float64)
    return {"shape": list(a.shape), "sum": float(f64.sum()), "sumsq": float((f64 * f64).sum()),
            "first": [float(v) for v in flat[:4]]}


def main(argv: list[str]) -> int:
    if len(argv) != 2 or argv[0] != "--fingerprints":
        print(__doc__)
        return 2
    jax.config.update("jax_platforms", "cpu")
    from xai_audio_deepfakes_tpu_torch.train.closed_loop import anyband_protocol_config

    jcfg = JPipelineConfig(embedder=JEmbedder(**PROTOCOL_EMBEDDER))
    theirs = jax.jit(JaxPipeline(jcfg).init_params)(jax.random.PRNGKey(0))
    theirs = {sub: dict(leaves(jax.tree.map(np.asarray, theirs[sub])))
              for sub in ("encoder", "unet", "logreg")}
    out = {"seed": 0, "config": "closed_loop.anyband_protocol_config()",
           "leaves": {sub: {"/".join(p): fingerprint(a) for p, a in t.items()}
                      for sub, t in theirs.items()}}
    Path(argv[1]).write_text(json.dumps(out, separators=(",", ":")) + "\n")
    mine = rd.jax_init_params(anyband_protocol_config(), 0, device="cpu")
    worst, n_diff, n = 0, 0, 0
    for sub, t in theirs.items():
        m = dict(leaves(mine[sub]))
        for p, a in t.items():
            d = ulps(a, m[p])
            worst, n_diff, n = max(worst, int(d.max())), n_diff + int((d > 0).sum()), n + d.size
    print(json.dumps({"values": n, "differing": n_diff, "max_ulps": worst}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
