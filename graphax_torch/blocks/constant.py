"""Constant block: the normalised adjacency as a fixed diffusion operator
over the whole solve (port of `graphax/blocks/constant.py`)."""

from __future__ import annotations

from torch import nn

from graphax_torch.blocks.common import (
    BlockOutput, integrate, make_fstate, normalize_graph,
)
from graphax_torch.functions import get_function


class ConstantBlock(nn.Module):
    def __init__(self, cfg, in_dim: int):
        super().__init__()
        self.cfg = cfg
        self.func = get_function(cfg, in_dim)

    def reset_parameters(self, generator) -> None:
        self.func.reset_parameters(generator)

    def forward(self, graph, x, *, train: bool, t1=None, observer=None,
                max_steps=None) -> BlockOutput:
        g = normalize_graph(self.cfg, graph)
        fstate = make_fstate(g, x, train=train, cfg=self.cfg)
        return integrate(self.cfg, self.func, fstate, x, train=train, t1=t1,
                         observer=observer, max_steps=max_steps)
