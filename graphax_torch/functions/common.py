"""Shared diffusion-RHS machinery (port of `graphax/functions/common.py`).

The learnable ``alpha_train``/``beta_train`` scalars live on the RHS module;
the per-forward context is an explicit :class:`FuncState`."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from graphax_torch.sparse.graph import Graph


@dataclasses.dataclass(frozen=True)
class FuncState:
    """Per-forward context of a diffusion RHS.

    Attributes:
      graph: normalised topology and edge weights.
      x0: the encoder output at t=0, detached (source term).
      wb: ``[E_pad]`` edge values in the state dtype (the graph's weights
        or the attention a block pinned), built once per forward. On a
        windowed graph: the residual edges' values in its CSR slot order.
        None on a dense graph.
      wb_t: the same values in the CSC slot order (for ``A^T g``).
      dense: on a windowed graph, the in-window values as dense
        ``[T, tile, W]`` blocks in the state dtype (for the transformer RHS
        only under reweight); on a dense graph the
        ``[N, N]`` operator in the values' dtype (graphax's ``dense_adj``);
        else None.
      mask: on a dense graph under the transformer RHS's dense route, the
        ``[N, N]`` bool adjacency, built once per forward; else None.
      pinned: the values are attention a block pinned, not the graph's
        weights (graphax then keeps both as adjoint leaves).
      second_order: a regulariser differentiates the RHS inside it, and
        the loss is differentiated through that (set by
        `graphax_torch.blocks.common.integrate`): the transformer RHS then
        takes a route whose backward is autograd's.
    """

    graph: Graph
    x0: torch.Tensor
    wb: torch.Tensor | None = None
    wb_t: torch.Tensor | None = None
    dense: torch.Tensor | None = None
    mask: torch.Tensor | None = None
    pinned: bool = False
    second_order: bool = False


def init_alpha_beta(module: nn.Module) -> None:
    """`alpha_train`/`beta_train` initialised to 0.0
    (`src/base_classes.py:125-126`)."""
    module.alpha_train = nn.Parameter(torch.zeros(()))
    module.beta_train = nn.Parameter(torch.zeros(()))


def prepare_scalars(module: nn.Module, cfg, dtype):
    """(alpha, beta) once per forward, outside the solver loop, cast to the
    state dtype; gradients flow back to alpha_train/beta_train."""
    alpha = module.alpha_train
    if not cfg.no_alpha_sigmoid:
        alpha = torch.sigmoid(alpha)
    return alpha.to(dtype), module.beta_train.to(dtype)


def apply_alpha_beta(cfg, alpha, beta, ax, x, x0):
    """``f = alpha (ax - x) [+ beta x0]``, every term in the state dtype."""
    f = alpha.to(x.dtype) * (ax.to(x.dtype) - x)
    if cfg.add_source:
        f = f + beta.to(x.dtype) * x0.to(x.dtype)
    return f
