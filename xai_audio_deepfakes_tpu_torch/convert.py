"""Weight bridge: the JAX package's parameter tree -> the port's modules,
and the trained decoder back (`unet_variables_to_jax`, `train_state_to_jax`)
so that a test can hold updated parameters and running statistics against
the JAX train state leaf by leaf.

Input: the tree of `ADDvisorPipeline.init_params(...)` (or one loaded from a
JAX checkpoint) with every leaf converted to a numpy array:
  {"encoder": {"params": ...}, "unet": {"params": ..., "batch_stats": ...},
   "logreg": {"weight": [D, 1], "bias": [1]},
   "quant_scales": {site: [n_layers, C_site]}  (after `calibrate_quant`)}
The layout rules invert those of the JAX package's importers
(`models/unet.py::params_from_torch_state_dict`,
`models/wav2vec2.py::params_from_hf_state_dict`):
  Dense [in, out]                  -> Linear [out, in]
  conv1d [k, Cin, Cout]            -> [Cout, Cin, k]
  grouped conv1d [k, in/g, out]    -> [out, in/g, k]
  conv2d HWIO                      -> OIHW
  ConvTranspose [kh, kw, in, out]  -> [in, out, kh, kw], both spatial axes
                                      flipped back
  BatchNorm scale/bias + batch_stats mean/var
                                   -> weight/bias/running_mean/running_var
"""

from __future__ import annotations

import numpy as np
import torch

from xai_audio_deepfakes_tpu_torch.models.unet import UNetMaskDecoder
from xai_audio_deepfakes_tpu_torch.models.wav2vec2 import Wav2Vec2Encoder


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a positive-stride copy


def _set(param: torch.Tensor, value) -> None:
    value = _t(value)
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"shape {tuple(value.shape)} does not fit {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value)


def unet_state_dict_from_jax(variables: dict) -> dict:
    """flax UNet variables -> a state dict in the reference's naming, which
    `UNetMaskDecoder.load_state_dict` takes."""
    p, stats = variables["params"], variables["batch_stats"]
    sd: dict = {}

    def conv(prefix, leaf):
        sd[f"{prefix}.weight"] = _t(leaf["kernel"]).permute(3, 2, 0, 1).contiguous()
        sd[f"{prefix}.bias"] = _t(leaf["bias"])

    def bn(prefix, leaf, stat):
        sd[f"{prefix}.weight"] = _t(leaf["scale"])
        sd[f"{prefix}.bias"] = _t(leaf["bias"])
        sd[f"{prefix}.running_mean"] = _t(stat["mean"])
        sd[f"{prefix}.running_var"] = _t(stat["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    for name in ("e1", "e2", "e3", "e4", "d1", "d2", "d3", "d4"):
        conv(f"{name}.block.0", p[name]["conv1"])
        bn(f"{name}.block.1", p[name]["bn1"], stats[name]["bn1"])
        conv(f"{name}.block.3", p[name]["conv2"])
        bn(f"{name}.block.4", p[name]["bn2"], stats[name]["bn2"])
    conv("bottleneck.0", p["bneck_conv1"])
    bn("bottleneck.1", p["bneck_bn1"], stats["bneck_bn1"])
    conv("bottleneck.3", p["bneck_conv2"])
    bn("bottleneck.4", p["bneck_bn2"], stats["bneck_bn2"])
    for i in (1, 2, 3, 4):
        k = np.asarray(p[f"up{i}"]["kernel"])[::-1, ::-1]  # [kh, kw, in, out]
        sd[f"up{i}.weight"] = _t(k).permute(2, 3, 0, 1).contiguous()
        sd[f"up{i}.bias"] = _t(p[f"up{i}"]["bias"])
    conv("mask_head.0", p["mask_head"])
    return sd


def unet_variables_to_jax(model: UNetMaskDecoder) -> dict:
    """The inverse of `unet_state_dict_from_jax`: the port's UNet as flax
    variables {"params", "batch_stats"} of numpy arrays."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    p: dict = {}
    stats: dict = {}

    def conv(prefix):
        return {"kernel": sd[f"{prefix}.weight"].transpose(2, 3, 1, 0),
                "bias": sd[f"{prefix}.bias"]}

    def bn(prefix):
        return ({"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]},
                {"mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]})

    for name in ("e1", "e2", "e3", "e4", "d1", "d2", "d3", "d4"):
        (bn1, st1), (bn2, st2) = bn(f"{name}.block.1"), bn(f"{name}.block.4")
        p[name] = {"conv1": conv(f"{name}.block.0"), "bn1": bn1,
                   "conv2": conv(f"{name}.block.3"), "bn2": bn2}
        stats[name] = {"bn1": st1, "bn2": st2}
    for i, conv_idx in ((1, 0), (2, 3)):
        p[f"bneck_conv{i}"] = conv(f"bottleneck.{conv_idx}")
        p[f"bneck_bn{i}"], stats[f"bneck_bn{i}"] = bn(f"bottleneck.{conv_idx + 1}")
    for i in (1, 2, 3, 4):
        k = sd[f"up{i}.weight"].transpose(2, 3, 0, 1)[::-1, ::-1]  # [kh, kw, in, out], flipped
        p[f"up{i}"] = {"kernel": np.ascontiguousarray(k), "bias": sd[f"up{i}.bias"]}
    p["mask_head"] = conv("mask_head.0")
    return {"params": p, "batch_stats": stats}


def train_state_to_jax(state) -> dict:
    """An `AddvisorTrainState` as numpy, under the field names of the JAX
    package's train state (the optimisers' moments are left out)."""
    variables = unet_variables_to_jax(state.decoder)
    return {"unet_params": variables["params"], "unet_batch_stats": variables["batch_stats"],
            "w_raw": state.w_raw.detach().cpu().numpy(), "step": state.step}


def load_unet(model: UNetMaskDecoder, variables: dict) -> None:
    sd = unet_state_dict_from_jax(variables)
    device = next(model.parameters()).device
    model.load_state_dict({k: v.to(device) for k, v in sd.items()})


def load_encoder(enc: Wav2Vec2Encoder, params: dict) -> None:
    """flax Wav2Vec2Encoder params (the tree under "params") -> `enc`."""
    fe = params["feature_encoder"]
    for i, block in enumerate(enc.feature_encoder.conv_layers):
        leaf = fe[f"conv_{i}"]
        _set(block.conv.weight, np.asarray(leaf["conv"]["kernel"]).transpose(2, 1, 0))
        if block.conv.bias is not None:
            _set(block.conv.bias, leaf["conv"]["bias"])
        _set(block.layer_norm.weight, leaf["layer_norm"]["scale"])
        _set(block.layer_norm.bias, leaf["layer_norm"]["bias"])

    fp = params["feature_projection"]
    proj = enc.feature_projection
    _set(proj.layer_norm.weight, fp["layer_norm"]["scale"])
    _set(proj.layer_norm.bias, fp["layer_norm"]["bias"])
    _set(proj.projection.weight, np.asarray(fp["projection"]["kernel"]).T)
    _set(proj.projection.bias, fp["projection"]["bias"])

    pc = params["pos_conv"]["conv"]
    _set(enc.pos_conv.conv.weight, np.asarray(pc["kernel"]).transpose(2, 1, 0))
    _set(enc.pos_conv.conv.bias, pc["bias"])

    for i, layer in enumerate(enc.layers):
        leaf = params[f"layer_{i}"]
        for ln, name in ((layer.attn_ln, "attn_ln"), (layer.ffn_ln, "ffn_ln")):
            _set(ln.weight, leaf[name]["scale"])
            _set(ln.bias, leaf[name]["bias"])
        # q/k/v/out are head-padded (`HeadDense`) with fused attention and
        # plain `Dense` without; both read the same unpadded flax leaves
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense = getattr(layer, name)
            dense.set_dense(
                _t(np.asarray(leaf[name]["kernel"]).T).to(dense.weight.device),
                _t(leaf[name]["bias"]).to(dense.weight.device),
            )
        for name in ("ffn_in", "ffn_out"):
            dense = getattr(layer, name)
            _set(dense.weight, np.asarray(leaf[name]["kernel"]).T)
            _set(dense.bias, leaf[name]["bias"])

    if enc.final_ln is not None:
        _set(enc.final_ln.weight, params["final_ln"]["scale"])
        _set(enc.final_ln.bias, params["final_ln"]["bias"])


def load_quant_scales(pipe, scales: dict) -> None:
    """A JAX `params["quant_scales"]` tree ({site: [n_layers, C_site]}, the
    output of its `calibrate_quant`) -> the pipeline's static int8 scales."""
    pipe.quant_scales = {k: _t(v).to(pipe.device) for k, v in scales.items()}


def load_jax_params(pipe, params: dict) -> None:
    """Set every weight of a port `ADDvisorPipeline` from a JAX pipeline's
    numpy parameter tree, and its static int8 scales where the tree carries
    them."""
    load_encoder(pipe.encoder, params["encoder"]["params"])
    load_unet(pipe.unet, params["unet"])
    pipe.logreg = {
        "weight": _t(params["logreg"]["weight"]).to(pipe.device),
        "bias": _t(params["logreg"]["bias"]).to(pipe.device),
    }
    if "quant_scales" in params:
        load_quant_scales(pipe, params["quant_scales"])
