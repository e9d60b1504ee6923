"""Shared diffusion-RHS machinery (port of `graphax/functions/common.py`).

The learnable ``alpha_train``/``beta_train`` scalars live on the RHS module;
the per-forward context is an explicit :class:`FuncState`. The multimodal
cross-attention (`CrossModal`, `cross_modal_apply`) is shared by the three
functions."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from graphax_torch.sparse.graph import Graph
from graphax_torch.utils.params import linear_apply, linear_init


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
      y: the second modality's tokens for the cross-modal attention of a
        ``multi_modal`` config: ``[M, D2]`` for a ``[N, D]`` state, ``[B,
        M, D2]`` for a batch (a ``[B, N, D]`` state, or the ``[B N, D]``
        state of a block-diagonal union of B graphs of N nodes each).
    """

    graph: Graph
    x0: torch.Tensor
    wb: torch.Tensor | None = None
    wb_t: torch.Tensor | None = None
    dense: torch.Tensor | None = None
    mask: torch.Tensor | None = None
    pinned: bool = False
    second_order: bool = False
    y: torch.Tensor | None = None


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


class _Linear(NamedTuple):
    """A linear layer's tensors, as `linear_apply` reads them."""
    weight: torch.Tensor
    bias: torch.Tensor


class CrossTensors(NamedTuple):
    """`CrossModal`'s tensors as plain tensors (the adjoint's flat layout
    ``(Wq2, bq2, Wk2, bk2, Wv2, bv2)``)."""
    Q2: _Linear
    K2: _Linear
    V2: _Linear

    @staticmethod
    def flatten(cross) -> tuple:
        return tuple(t for n in ("Q2", "K2", "V2")
                     for t in (getattr(cross, n).weight,
                               getattr(cross, n).bias))

    @classmethod
    def from_flat(cls, flat) -> "CrossTensors":
        return cls(*(_Linear(flat[i], flat[i + 1]) for i in range(0, 6, 2)))


class CrossModal(nn.Module):
    """Q2/K2/V2 projections of the fork's multimodal cross-attention
    (graphax `cross_modal_init`, `src/function_laplacian_diffusion.py:
    29-37`): ``Q2 [D -> D]`` on the nodes, ``K2``, ``V2 [D2 -> D]`` on the
    second modality, weights constant 1e-5 and torch-default biases."""

    def __init__(self, in_dim: int, second_dim: int):
        super().__init__()
        self.Q2 = nn.Linear(in_dim, in_dim)
        self.K2 = nn.Linear(second_dim, in_dim)
        self.V2 = nn.Linear(second_dim, in_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in (self.Q2, self.K2, self.V2):
            linear_init(layer, generator, "const", 1e-5)


def cross_modal_apply(cross, x: torch.Tensor, y: torch.Tensor
                      ) -> torch.Tensor:
    """``softmax(Q2(x) K2(y)^T / sqrt(d)) V2(y)``, the nodes' dense attention
    over the second modality's tokens (graphax `cross_modal_apply`), in
    x's dtype. No mask on zero-padded tokens, as graphax. ``cross`` is a
    `CrossModal` or its `CrossTensors`. A batch ``y [B, M, D2]`` meets
    ``x [B, N, D]``, or ``x [B N, D]`` (a union of B graphs of N nodes,
    sample-major), each sample against its own tokens."""
    shape = x.shape
    if y.dim() == 3 and x.dim() == 2:
        x = x.reshape(y.shape[0], -1, shape[-1])
    q = linear_apply(cross.Q2, x)
    k = linear_apply(cross.K2, y)
    v = linear_apply(cross.V2, y)
    # sqrt(d) rounded to q's dtype, as graphax's, on the host
    d = float(torch.tensor(q.shape[-1], dtype=q.dtype).sqrt())
    scores = (q @ k.transpose(-1, -2)) / d
    out = torch.softmax(scores, dim=-1) @ v
    return out.reshape(shape).to(x.dtype)
