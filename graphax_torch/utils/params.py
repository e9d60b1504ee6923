"""Linear layers: init and apply.

Port of `graphax/utils/params.py:47-76`. graphax keeps ``{'w': [in, out],
'b': [out]}`` dicts applied as ``x @ w + b``; the port keeps
``nn.Linear`` modules (weight ``[out, in]``), and
`graphax_torch.utils.transplant` maps one onto the other."""

from __future__ import annotations

import math

import torch
from torch import nn


def linear_init(layer: nn.Linear, generator: torch.Generator,
                weight_init: str = "torch", weight_const: float | None = None
                ) -> nn.Linear:
    """Initialise ``layer`` in place.

    weight_init: 'torch' (kaiming-uniform, torch Linear default:
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))) or 'const' (every weight
    ``weight_const``, the attention-layer init). The bias is always the
    torch default U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    fan_in = layer.in_features
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    dev = layer.weight.device
    with torch.no_grad():
        if weight_init == "const":
            layer.weight.fill_(float(weight_const))
        elif weight_init == "torch":
            u = torch.rand(layer.weight.shape, generator=generator,
                           device=generator.device)
            layer.weight.copy_((u * 2 - 1).to(dev) * bound)
        else:
            raise ValueError(f"unknown weight_init {weight_init!r}")
        if layer.bias is not None:
            u = torch.rand(layer.bias.shape, generator=generator,
                           device=generator.device)
            layer.bias.copy_((u * 2 - 1).to(dev) * bound)
    return layer


def linear_apply(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` computed in the layer's dtype: a bf16 ``x`` meets f32
    weights in f32, as graphax's type promotion does."""
    return nn.functional.linear(x.to(layer.weight.dtype), layer.weight,
                                layer.bias)
