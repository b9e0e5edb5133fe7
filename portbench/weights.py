"""The benchmark's weights: drawn on the device from the seed, in a few large
calls, each leaf in the type it is served in; set into the port through its
modules' parameters and setters; kept on the host during the window and
handed, unchanged, to the plain reference afterwards.

Leaves (the reference's names, `reference/wav2vec2.py` and
`reference/unet.py`): products' weights N(0, 1 / fan_in), biases
N(0, bias_std^2), LayerNorm and BatchNorm scales 1 + N(0, norm_std^2) and
shifts N(0, norm_std^2), the head's direction N(0, 1). Then two settings
are made from `calibration_clips` seeded clips by the plain reference in
float32, under deterministic cuDNN: every BatchNorm's running statistics are
the batch statistics of its input, and the head's weight and bias are scaled
so that its logits over those clips have mean 0 and standard deviation
`logit_std` (a random head on random features would otherwise give
probabilities of 0 or 1 that no comparison can read).
"""

from __future__ import annotations

import torch

from portbench import clips as clip_gen
from portbench.reference import explain as ref_explain
from portbench.reference import spectral, unet as ref_unet, wav2vec2 as ref_w2v

_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def leaves(cfg: dict) -> list:
    """[(name, shape, kind, dtype name, fan_in)] of every weight, in draw
    order. kind: "w" product weight, "b" bias, "s" norm scale, "t" norm
    shift, "d" head direction."""
    e, u = cfg["embedder"], cfg["unet"]
    dt, quant = e["dtype"], e.get("quant", "none") != "none"
    out = []
    cin = 1
    for i, (cout, k) in enumerate(zip(e["conv_dim"], e["conv_kernel"])):
        out += [(f"fe.{i}.conv.weight", (cout, cin, k), "w", dt, cin * k),
                (f"fe.{i}.conv.bias", (cout,), "b", dt, 0),
                (f"fe.{i}.ln.weight", (cout,), "s", "float32", 0),
                (f"fe.{i}.ln.bias", (cout,), "t", "float32", 0)]
        cin = cout
    h, inter = e["hidden_size"], e["intermediate_size"]
    out += [("fp.ln.weight", (cin,), "s", "float32", 0), ("fp.ln.bias", (cin,), "t", "float32", 0),
            ("fp.proj.weight", (h, cin), "w", dt, cin), ("fp.proj.bias", (h,), "b", dt, 0)]
    pdt = "float32" if quant else dt
    g, kpos = e["num_conv_pos_embedding_groups"], e["num_conv_pos_embeddings"]
    out += [("pos.weight", (h, h // g, kpos), "w", pdt, kpos * h // g),
            ("pos.bias", (h,), "b", pdt, 0)]
    for i in range(min(e["num_layers"], e["output_layer"])):
        p = f"l{i}."
        out += [(p + "attn_ln.weight", (h,), "s", "float32", 0),
                (p + "attn_ln.bias", (h,), "t", "float32", 0)]
        for name in ("q", "k", "v", "o"):
            out += [(p + name + ".weight", (h, h), "w", pdt, h),
                    (p + name + ".bias", (h,), "b", pdt, 0)]
        out += [(p + "ffn_ln.weight", (h,), "s", "float32", 0),
                (p + "ffn_ln.bias", (h,), "t", "float32", 0),
                (p + "ffn_in.weight", (inter, h), "w", pdt, h),
                (p + "ffn_in.bias", (inter,), "b", pdt, 0),
                (p + "ffn_out.weight", (h, inter), "w", pdt, inter),
                (p + "ffn_out.bias", (h,), "b", pdt, 0)]
    for name, (shape, transposed) in ref_unet.conv_shapes(u["base_channels"]).items():
        fan = shape[0 if transposed else 1] * shape[2] * shape[3]
        out += [(name + ".weight", shape, "w", "float32", fan),
                (name + ".bias", (shape[1] if transposed else shape[0],), "b", "float32", 0)]
    for name, ch in ref_unet.batch_norms(u["base_channels"]).items():
        out += [(name + ".weight", (ch,), "s", "float32", 0),
                (name + ".bias", (ch,), "t", "float32", 0)]
    out += [("logreg.weight", (h, 1), "d", "float32", 0), ("logreg.bias", (1,), "t", "float32", 0)]
    return out


def draw(cfg: dict, wcfg: dict, seed: int, device) -> dict:
    """Every leaf from one float32 normal draw of the seed's generator."""
    spec = leaves(cfg)
    sizes = [int(torch.Size(shape).numel()) for _, shape, *_ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, kind, dtype, fan), size in zip(spec, sizes):
        z = flat[at:at + size].view(shape)
        at += size
        if kind == "w":
            v = z * fan ** -0.5
        elif kind == "b":
            v = z * wcfg["bias_std"]
        elif kind == "s":
            v = 1.0 + z * wcfg["norm_std"]
        elif kind == "t":
            v = z * wcfg["norm_std"]
        else:
            v = z.clone()
        out[name] = v.to(_DT[dtype])
    return out


def calibrate(w: dict, cfg: dict, wcfg: dict, traffic: dict, seed: int, device) -> None:
    """Set the BatchNorm statistics and the head's scale in `w` (see the
    module docstring) from clips of a generator seeded apart from the
    traffic's."""
    n = int(cfg["audio"]["clip_seconds"] * cfg["audio"]["sample_rate"])
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    wav = clip_gen.speechlike(gen, wcfg["calibration_clips"], n, cfg["audio"]["sample_rate"],
                              traffic["clips"], device)
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad(), ref_explain.precise():
            mag = spectral.stft(wav, cfg["stft"]).abs()
            u = dict(cfg["unet"], dtype="float32")
            ref_unet.forward(w, mag[:, :u["freq_bins"], :u["frames"]], u, calibrate=True)
            e = dict(cfg["embedder"], dtype="float32", quant="none")
            w32 = {k: v.float() for k, v in w.items()}
            pooled = ref_w2v.embed(w32, wav, e).mean(dim=1)
    finally:
        torch.backends.cudnn.deterministic = before
    z = (pooled @ w["logreg.weight"])[:, 0]
    scale = wcfg["logit_std"] / z.std()
    w["logreg.weight"] = w["logreg.weight"] * scale
    w["logreg.bias"] = -(z.mean() * scale).reshape(1)
    for name in ref_unet.batch_norms(cfg["unet"]["base_channels"]):
        w[name + ".num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)


def unet_state_dict(w: dict, c: int) -> dict:
    names = list(ref_unet.conv_shapes(c))
    keys = [n + s for n in names for s in (".weight", ".bias")]
    keys += [n + s for n in ref_unet.batch_norms(c)
             for s in (".weight", ".bias", ".running_mean", ".running_var", ".num_batches_tracked")]
    return {k: w[k] for k in keys}


@torch.no_grad()
def load_into(pipe, w: dict) -> None:
    """Set every weight of the port's pipeline from `w`."""
    enc = pipe.encoder
    for i, block in enumerate(enc.feature_encoder.conv_layers):
        block.conv.weight.copy_(w[f"fe.{i}.conv.weight"])
        block.conv.bias.copy_(w[f"fe.{i}.conv.bias"])
        block.layer_norm.weight.copy_(w[f"fe.{i}.ln.weight"])
        block.layer_norm.bias.copy_(w[f"fe.{i}.ln.bias"])
    proj = enc.feature_projection
    proj.layer_norm.weight.copy_(w["fp.ln.weight"])
    proj.layer_norm.bias.copy_(w["fp.ln.bias"])
    proj.projection.set_dense(w["fp.proj.weight"], w["fp.proj.bias"])
    enc.pos_conv.conv.weight.copy_(w["pos.weight"])
    enc.pos_conv.conv.bias.copy_(w["pos.bias"])
    for i, layer in enumerate(enc.layers):
        p = f"l{i}."
        for ln, name in ((layer.attn_ln, "attn_ln"), (layer.ffn_ln, "ffn_ln")):
            ln.weight.copy_(w[p + name + ".weight"])
            ln.bias.copy_(w[p + name + ".bias"])
        for dense, name in ((layer.q_proj, "q"), (layer.k_proj, "k"), (layer.v_proj, "v"),
                            (layer.out_proj, "o"), (layer.ffn_in, "ffn_in"),
                            (layer.ffn_out, "ffn_out")):
            dense.set_dense(w[p + name + ".weight"], w[p + name + ".bias"])
    pipe.unet.load_state_dict(unet_state_dict(w, pipe.cfg.unet.base_channels))
    pipe.logreg = {"weight": w["logreg.weight"].clone(), "bias": w["logreg.bias"].clone()}


def to(w: dict, device) -> dict:
    return {k: v.to(device) for k, v in w.items()}
