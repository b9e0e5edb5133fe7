"""The JAX package's random weights, drawn again without JAX: the encoder,
UNet and LogReg subtrees of `ADDvisorPipeline.init_params(PRNGKey(seed))`
(JAX `pipeline/core.py::init_params`), as numpy arrays in the JAX layout
that `convert.py::load_jax_params` takes.

The draw is a fixed function of public algorithms, rewritten here in
PyTorch:

  * jax's threefry2x32 counter PRNG with `jax_threefry_partitionable` on
    (jax's default since 0.5): `PRNGKey`, `split`, `fold_in`, 32-bit
    `random_bits`, `uniform` and `truncated_normal` as jax 0.9 computes them
    (`jax/_src/prng.py`, `jax/_src/random.py`);
  * flax linen's key per parameter: the scope's names and the scope's
    count of `make_rng` calls hashed with SHA-1 and folded into the
    module's key (`flax/core/scope.py::_fold_in_static`, `Scope.make_rng`;
    no separator between the names, flax's default);
  * `nn.scan(split_rngs={"params": True})` over the transformer layers:
    the raw key of the scanned scope split into one key per layer, its
    names kept (`flax/core/lift.py::scan`);
  * the initialisers: flax's `lecun_normal` (a normal truncated at +-2,
    times fan_in^-1/2 / 0.87962566), zeros and ones.

Random bits equal jax's exactly. The floats follow XLA's CPU code
operation by operation: `uniform`'s scale and shift and erfinv's
polynomial (Giles' f32 approximation) as the fused multiply-adds XLA
contracts them into, and erfinv's log1p and log as XLA's CPU emitter
writes them, so they equal the CPU's draw bit for bit but where an
emulated fused multiply-add rounds twice (f64, then f32) on a tie, a
chance of about 2^-29 a value. XLA on another backend (the TPU) may round
its own log differently by an ulp.

Generation runs leaf by leaf in chunks on the given device (the card by
default), so the full-width draw (about 435M values) takes seconds there.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from xai_audio_deepfakes_tpu_torch.config import EmbedderConfig, PipelineConfig, UNetConfig
from xai_audio_deepfakes_tpu_torch.device import resolve_device

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# XLA's f32 erf(-+2 / sqrt(2)): `truncated_normal`'s uniform bounds
ERF_LO = np.array(0xBF745A18, np.uint32).view(np.float32)
ERF_HI = np.array(0x3F745A18, np.uint32).view(np.float32)
TRUNCATED_STD = 0.87962566103423978  # std of a unit normal truncated at +-2
CHUNK = 1 << 24  # elements a chunk of `random_bits` computes at once

# XLA's f32 erfinv (stablehlo's chlo decomposition, after M. Giles,
# "Approximating the erfinv function"): Horner coefficients for w < 5 and
# for w >= 5, highest power first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


# ---------------------------------------------------------------------------
# jax.random, threefry2x32 (partitionable)
# ---------------------------------------------------------------------------


def threefry2x32(key: tuple[int, int], x0, x1):
    """The Threefry-2x32 block cipher of (x0, x1) under `key`, 20 rounds,
    as jax's `_threefry2x32_lowering`. x0, x1: Python ints or int64
    tensors holding uint32 values; returns the same kind."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """`jax.random.PRNGKey(seed)` for 0 <= seed < 2**32: (0, seed)."""
    if not 0 <= seed <= MASK32:
        raise ValueError(f"seed {seed} is outside [0, 2**32)")
    return (0, seed)


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """`jax.random.split(key, num)`: key i is the cipher of the counter
    (0, i)."""
    return [threefry2x32(key, 0, i) for i in range(num)]


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """`jax.random.fold_in(key, data)`: the cipher of (0, data)."""
    return threefry2x32(key, 0, data & MASK32)


def random_bits(key: tuple[int, int], n: int, start: int = 0, device="cpu") -> torch.Tensor:
    """Elements [start, start + n) of the flat `jax.random.bits(key, shape)`
    (uint32) of any shape with at least start + n elements, as int64: the
    two cipher words of the 64-bit counter i xored."""
    i = torch.arange(start, start + n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, i >> 32, i & MASK32)
    return b0 ^ b1


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 a * b + c rounded once, as XLA contracts it on the CPU: the
    product of two f32 values is exact in f64, the sum rounds to f64 and
    then to f32 (the two roundings differ from one only on a tie at f32's
    precision, a chance of about 2^-29). b and c: f32 tensors or
    f32-exact numbers."""
    f64 = torch.float64

    def wide(t):
        return t.to(f64) if isinstance(t, torch.Tensor) else float(t)

    return (a.to(f64) * wide(b) + wide(c)).to(torch.float32)


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """`uniform`'s floats in [0, 1): 23 high bits as the mantissa of 1.x,
    minus 1 (f32)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0, device="cpu") -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
    n = math.prod(shape)
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    f = _unit_floats(random_bits(key, n, device=device))
    return torch.maximum(lo, fma_f32(f, hi - lo, lo)).reshape(shape)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """XLA's polynomial evaluation: p = p * x + c from the highest power
    down, each step one fused multiply-add."""
    p = torch.zeros_like(x)
    for c in coeffs:
        p = fma_f32(p, x, np.float32(c))
    return p


# XLA's CPU f32 log (Cephes' logf, as `polynomial_approximations.cc` emits
# it) and log1p (Cephes' rational approximation for |x| < sqrt(2) - 1,
# log(1 + x) beyond, `elemental_ir_emitter.cc::EmitLog1p`)
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
          1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
          3.3333331174E-1)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)


def xla_log_f32(v: torch.Tensor) -> torch.Tensor:
    """XLA's CPU f32 natural log of positive normal `v`: v = m 2^e with m
    in [sqrt(1/2), sqrt(2)), a degree-8 polynomial in m - 1 evaluated in
    three interleaved parts, e ln 2 added in two pieces."""
    f32 = torch.float32
    bits = v.view(torch.int32)
    e = (((bits >> 23) & 0xFF) - 126).to(f32)
    m = ((bits & -2139095041) | 0x3F000000).view(f32)  # mantissa in [0.5, 1)
    small = m < np.float32(0.707106781186547524)
    e = e - small.to(f32)
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = x * x
    x3 = x2 * x
    p = [np.float32(c) for c in _LOG_P]
    y, y1, y2 = fma_f32(x, p[0], p[1]), fma_f32(x, p[3], p[4]), fma_f32(x, p[6], p[7])
    y, y1, y2 = fma_f32(y, x, p[2]), fma_f32(y1, x, p[5]), fma_f32(y2, x, p[8])
    y = fma_f32(y, x3, y1)
    y = fma_f32(y, x3, y2)
    y = fma_f32(y, x3, e * np.float32(-2.12194440e-4))
    x = x - x2 * 0.5
    x = x + y
    return x + e * np.float32(0.693359375)


def xla_log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU f32 log1p for x > -1."""
    x2 = x * x
    ratio = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + fma_f32(x2, np.float32(-0.5), (x * x2) * ratio)
    return torch.where(x.abs() < 0.41421356237309504880, small, xla_log_f32(x + 1.0))


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 erfinv: w = -log1p(-x * x); Giles' polynomial in
    w - 2.5 (w < 5) or sqrt(w) - 3, times x; +-inf at +-1."""
    w = -xla_log1p_f32(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.zeros_like(x)
    for c_lt, c_ge in zip(_ERFINV_LT5, _ERFINV_GE5):
        p = fma_f32(p, w, torch.where(lt, np.float32(c_lt), np.float32(c_ge)))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _truncated_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """`truncated_normal(key, -2, 2)`'s values from its uniform bits."""
    lo = torch.tensor(ERF_LO, device=bits.device)
    hi = torch.tensor(ERF_HI, device=bits.device)
    u = torch.maximum(lo, fma_f32(_unit_floats(bits), hi - lo, lo))
    out = torch.tensor(np.float32(np.sqrt(2)), device=bits.device) * erfinv_f32(u)
    bound = float(np.nextafter(np.float32(2.0), np.float32(0.0)))
    return out.clamp(-bound, bound)


def truncated_normal(key, shape, device="cpu") -> torch.Tensor:
    """`jax.random.truncated_normal(key, -2, 2, shape, float32)`."""
    return _truncated_from_bits(random_bits(key, math.prod(shape), device=device)).reshape(shape)


def lecun_normal(key, shape, device="cpu", out: torch.Tensor | None = None) -> torch.Tensor:
    """flax's `lecun_normal()(key, shape, float32)`: fan_in is the product
    of every dim but the last. Drawn in chunks of `CHUNK` into `out`."""
    fan_in = math.prod(shape[:-1])
    std = np.sqrt(np.float32(1.0 / fan_in)) / np.float32(TRUNCATED_STD)
    n = math.prod(shape)
    flat = torch.empty(n, dtype=torch.float32, device=device) if out is None else out.view(-1)
    for s in range(0, n, CHUNK):
        k = min(CHUNK, n - s)
        flat[s:s + k] = _truncated_from_bits(random_bits(key, k, s, device)) * float(std)
    return flat.view(shape)


# ---------------------------------------------------------------------------
# flax linen's keys
# ---------------------------------------------------------------------------


def flax_param_key(base: tuple[int, int], names: tuple[str, ...], count: int) -> tuple[int, int]:
    """The key flax hands the `count`-th `make_rng("params")` call of the
    scope whose names (from the key's scope on) are `names`: SHA-1 of the
    names and the count's big-endian bytes, its first 4 bytes folded in."""
    m = hashlib.sha1()
    for x in (*names, count):
        m.update(x.encode("utf-8") if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return fold_in(base, int.from_bytes(m.digest()[:4], byteorder="big"))


# Every random leaf is the first parameter its scope creates: count 1. Under
# nn.scan it is count 3: flax traces the scan body twice while it
# initialises (once for the carry's shape) and the scope's counters run on
# from the first trace (2 parameters a scope) into the one that is kept.
SCANNED_COUNT = 3


def _dense(path, cin, cout, bias=True):
    yield (*path, "kernel"), "lecun", (cin, cout)
    if bias:
        yield (*path, "bias"), "zeros", (cout,)


def _norm(path, c):
    yield (*path, "scale"), "ones", (c,)
    yield (*path, "bias"), "zeros", (c,)


def encoder_leaves(cfg: EmbedderConfig):
    """(path under "params", initialiser, shape) of every leaf of
    `Wav2Vec2Encoder(cfg).init`; the stacked layers' paths start with
    "layers" and their shapes leave out the layer axis."""
    cin = 1
    for i, (dim, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        blk = ("feature_encoder", f"conv_{i}")
        yield (*blk, "conv", "kernel"), "lecun", (k, cin, dim)
        if cfg.conv_bias:
            yield (*blk, "conv", "bias"), "zeros", (dim,)
        yield from _norm((*blk, "layer_norm"), dim)
        cin = dim
    yield from _norm(("feature_projection", "layer_norm"), cin)
    yield from _dense(("feature_projection", "projection"), cin, cfg.hidden_size)
    h = cfg.hidden_size
    yield (("pos_conv", "conv", "kernel"), "lecun",
           (cfg.num_conv_pos_embeddings, h // cfg.num_conv_pos_embedding_groups, h))
    yield ("pos_conv", "conv", "bias"), "zeros", (h,)
    if cfg.scan_layers:
        prefixes = [("layers", "layer")]
    else:
        prefixes = [(f"layer_{i}",) for i in range(min(cfg.output_layer, cfg.num_layers))]
    for pre in prefixes:
        yield from _norm((*pre, "attn_ln"), h)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            yield from _dense((*pre, name), h, h)
        yield from _norm((*pre, "ffn_ln"), h)
        yield from _dense((*pre, "ffn_in"), h, cfg.intermediate_size)
        yield from _dense((*pre, "ffn_out"), cfg.intermediate_size, h)
    if cfg.final_layer_norm:
        yield from _norm(("final_ln",), h)


def _conv2d(path, kh, kw, cin, cout):
    yield (*path, "kernel"), "lecun", (kh, kw, cin, cout)  # HWIO
    yield (*path, "bias"), "zeros", (cout,)


def _conv_block(name, cin, cout, kernel):
    yield from _conv2d((name, "conv1"), *kernel, cin, cout)
    yield from _norm((name, "bn1"), cout)
    yield from _conv2d((name, "conv2"), 3, 3, cout, cout)
    yield from _norm((name, "bn2"), cout)


def unet_leaves(cfg: UNetConfig):
    """(path under "params", initialiser, shape) of every parameter of
    `UNetMaskDecoder(cfg).init`; each BatchNorm's running statistics are
    the "batch_stats" leaves beside its "scale"."""
    c = cfg.base_channels
    yield from _conv_block("e1", 1, c, (5, 3))
    yield from _conv_block("e2", c, 2 * c, (5, 3))
    yield from _conv_block("e3", 2 * c, 4 * c, (3, 3))
    yield from _conv_block("e4", 4 * c, 8 * c, (3, 3))
    yield from _conv2d(("bneck_conv1",), 3, 3, 8 * c, 16 * c)
    yield from _norm(("bneck_bn1",), 16 * c)
    yield from _conv2d(("bneck_conv2",), 3, 3, 16 * c, 16 * c)
    yield from _norm(("bneck_bn2",), 16 * c)
    # ConvTranspose kernels are (kh, kw, in, out) too; then the skip concat
    for up, d, cin, cout, kernel, skip in (("up4", "d4", 16 * c, 8 * c, (2, 2), 4 * c),
                                           ("up3", "d3", 8 * c, 4 * c, (2, 2), 2 * c),
                                           ("up2", "d2", 4 * c, 2 * c, (2, 1), c),
                                           ("up1", "d1", 2 * c, c, (2, 1), 1)):
        yield from _conv2d((up,), *kernel, cin, cout)
        yield from _conv_block(d, cout + skip, cout, (3, 3))
    yield from _conv2d(("mask_head",), 1, 1, c, 1)


def _draw(kind: str, shape, keys, device) -> np.ndarray:
    """One leaf: zeros, ones, or `lecun_normal` from `keys` (one key, or a
    list of one per stacked layer, stacked on a leading axis)."""
    stacked = isinstance(keys, list)
    full = ((len(keys),) if stacked else ()) + tuple(shape)
    if kind != "lecun":
        return np.full(full, 1.0 if kind == "ones" else 0.0, np.float32)
    out = torch.empty(full, dtype=torch.float32, device=device)
    for i, key in enumerate(keys if stacked else [keys]):
        lecun_normal(key, shape, device, out=out[i] if stacked else out)
    return out.cpu().numpy()


def _put(tree: dict, path: tuple, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def jax_init_params(cfg: PipelineConfig, seed: int = 0, device="cuda") -> dict:
    """The encoder, UNet and LogReg subtrees of the JAX package's
    `ADDvisorPipeline(cfg).init_params(jax.random.PRNGKey(seed))`:
    {"encoder": {"params"}, "unet": {"params", "batch_stats"},
     "logreg": {"weight", "bias"}}, numpy f32 arrays in the JAX layout.
    The draw runs on `device`."""
    dev = resolve_device(device)
    k_enc, k_unet, _k_fd, _k_hg = split(prng_key(seed), 4)
    enc: dict = {}
    layer_keys = split(k_enc, cfg.embedder.num_layers)
    for path, kind, shape in encoder_leaves(cfg.embedder):
        names = path[:-1]
        keys = ([flax_param_key(k, names, SCANNED_COUNT) for k in layer_keys]
                if path[0] == "layers" else flax_param_key(k_enc, names, 1))
        _put(enc, path, _draw(kind, shape, keys, dev))
    params: dict = {}
    stats: dict = {}
    for path, kind, shape in unet_leaves(cfg.unet):
        _put(params, path, _draw(kind, shape, flax_param_key(k_unet, path[:-1], 1), dev))
        if path[-1] == "scale":  # a BatchNorm: its running statistics
            _put(stats, (*path[:-1], "mean"), np.zeros(shape, np.float32))
            _put(stats, (*path[:-1], "var"), np.ones(shape, np.float32))
    # the JAX package's `LogReg.init(hidden_size)`: numpy's own draw
    d = cfg.embedder.hidden_size
    rng = np.random.default_rng(0)
    weight = rng.standard_normal((d, 1)).astype(np.float32) / np.sqrt(d)
    logreg = {"weight": weight.astype(np.float32), "bias": np.zeros((1,), np.float32)}
    return {"encoder": {"params": enc}, "unet": {"params": params, "batch_stats": stats},
            "logreg": logreg}
