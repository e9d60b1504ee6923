"""Higher-order graph PDE block (port of `graphax/blocks/higher_order.py`):
the order reduction of ``x^(k) = f(x)``, the state ``(x, v_1, ...,
v_{k-1})`` with

    d/dt (x, v_1, ..., v_{k-1}) = (v_1, ..., v_{k-1}, f(x)),

integrated in one solve by the same `integrate` as every block (k = 2 is
the graph wave equation). ``order == 1`` is the constant block. No config
selects it; it is built directly, ``make_higher_order_block(cfg, in_dim,
order)``."""

from __future__ import annotations

import torch
from torch import nn

from graphax_torch.blocks.common import (
    BlockOutput, integrate, make_fstate, normalize_graph,
)
from graphax_torch.functions import get_function


def _order_reduction(rhs):
    """The RHS of ``(x, v_1, ...)`` from the function's ``rhs(t, x)``."""
    def aug(t, state):
        x, *vs = state
        return (*vs, rhs(t, x))
    return aug


class HigherOrderBlock(nn.Module):
    def __init__(self, cfg, in_dim: int, order: int = 2):
        super().__init__()
        if order < 1:
            raise ValueError("order must be at least 1")
        self.cfg = cfg
        self.order = order
        self.func = get_function(cfg, in_dim)

    def reset_parameters(self, generator) -> None:
        self.func.reset_parameters(generator)

    def forward(self, graph, x, *, train: bool, t1=None, observer=None,
                max_steps=None) -> BlockOutput:
        cfg = self.cfg
        g = normalize_graph(cfg, graph)
        fstate = make_fstate(g, x, train=train, cfg=cfg)
        if self.order == 1:
            return integrate(cfg, self.func, fstate, x, train=train, t1=t1,
                             observer=observer, max_steps=max_steps)
        state0 = (x,) + tuple(torch.zeros_like(x)
                              for _ in range(self.order - 1))
        out = integrate(cfg, self.func, fstate, state0, train=train, t1=t1,
                        observer=observer, max_steps=max_steps,
                        augment=_order_reduction)
        return out._replace(z=out.z[0])


def make_higher_order_block(cfg, in_dim: int, order: int = 2
                            ) -> HigherOrderBlock:
    """graphax's `make_higher_order_block`."""
    return HigherOrderBlock(cfg, in_dim, order)
