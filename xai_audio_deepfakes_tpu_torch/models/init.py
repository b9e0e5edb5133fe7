"""The random initialiser of every Dense and convolution weight of the port:
flax's `nn.initializers.lecun_normal()`, the default of `nn.Dense`, `nn.Conv`
and `nn.ConvTranspose` and the explicit initialiser of the JAX package's
embedder and UNet.

`lecun_normal` is `variance_scaling(1, "fan_in", "truncated_normal")`: a
normal truncated at two standard deviations, whose std is rescaled by
1 / 0.87962566 (the std of a unit normal truncated at +-2) so that the draw's
variance stays 1 / fan_in. fan_in is flax's: the product of the kernel's
dims but the last (receptive field x input features), so

  * Dense [out, in]                          -> in
  * conv [out, in / groups, *k]              -> (in / groups) x prod(k)
  * UNet ConvTranspose2d [in, out, kh, kw]   -> kh x kw x in (flax's kernel
    [kh, kw, in, out]; torch's `_calculate_fan_in_and_fan_out` takes out)
  * HiFi-GAN ConvTranspose1d [in, out, k]    -> k x out (flax's kernel with
    `transpose_kernel=True` is [k, out, in])

which the callers pass as `fan_in`.
"""

from __future__ import annotations

import torch

TRUNCATED_STD = 0.87962566103423978  # std of a unit normal truncated at +-2


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """Fill `weight` in place from `generator` with lecun_normal at `fan_in`:
    std = fan_in^-1/2 / 0.87962566, truncated at +-2 std (absolute bounds,
    as `trunc_normal_` takes them). The draw is made in f32 and cast, so a
    bf16 weight holds the rounded f32 draw."""
    std = fan_in**-0.5 / TRUNCATED_STD
    with torch.no_grad():
        draw = torch.empty(weight.shape, dtype=torch.float32, device=weight.device)
        torch.nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        weight.copy_(draw)
    return weight
