"""Dropout and batch-norm with graphax's state (port of
`graphax/models/layers.py`)."""

from __future__ import annotations

import torch
from torch import nn


def dropout(x, rate: float, train: bool, generator: torch.Generator | None):
    """Inverted dropout (F.dropout semantics) drawing its mask from an
    explicit generator; a no-op when not training, at rate 0 or without a
    generator."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator,
                      device=generator.device).to(x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class BatchNorm(nn.Module):
    """BatchNorm1d over the node axis with graphax's state (``mean``,
    ``var``, ``count``): batch statistics in training, where the running
    variance takes the unbiased batch variance; running statistics in
    eval."""

    def __init__(self, dim: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))
        self.register_buffer("count", torch.zeros(()))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)
            self.count.zero_()

    def forward(self, x, train: bool):
        if train:
            mean = x.mean(0)
            var = x.var(0, unbiased=False)
            n = x.numel() // x.shape[-1]
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_((1 - m) * self.mean + m * mean)
                self.var.copy_((1 - m) * self.var + m * (var * n / max(n - 1, 1)))
                self.count.add_(1)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.scale + self.bias
