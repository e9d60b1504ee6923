"""Continuous GNN (ICML'20) baseline (port of `graphax/models/cgnn.py`,
the twin of `CGNN`, `src/CGNN.py:73-171`).

RHS: ``f = sigmoid(alpha) * 1/2 (A x - x) + x0`` with a per-node learnable
``alpha`` (initialised to ``cfg.alpha``) and the symmetric-normalised
adjacency (:func:`normalize_for_cgnn`); the state is always ANODE-augmented
(the hidden width doubled with zeros): encoder m1, solve, truncate, relu,
dropout, m2. ``A x`` is the CSR SpMM (`graphax_torch.kernels.spmm`), on a
graph of any strategy (every graph carries its CSR and CSC layouts).
Parameter names follow graphax's tree: ``m1``, ``m2`` and ``alpha_train
[N]``, sized for a graph by :meth:`CGNN.init_for_graph`."""

from __future__ import annotations

import torch
from torch import nn

from graphax_torch.kernels.spmm import spmm, transpose_values
from graphax_torch.models.layers import dropout
from graphax_torch.ode import odeint
from graphax_torch.sparse.graph import Graph
from graphax_torch.sparse.ops import gcn_norm_weights
from graphax_torch.utils.params import linear_apply, linear_init


class CGNN(nn.Module):
    def __init__(self, cfg, num_features: int, num_classes: int):
        super().__init__()
        self.cfg = cfg
        self.hidden = cfg.hidden_dim
        self.m1 = nn.Linear(num_features, self.hidden)
        self.m2 = nn.Linear(self.hidden, num_classes)
        # resized per graph, as graphax's lazily sized leaf
        self.alpha_train = nn.Parameter(torch.zeros(0))

    def init_for_graph(self, graph: Graph, generator: torch.Generator
                       ) -> "CGNN":
        """Fresh m1 and m2 from ``generator`` and ``alpha_train`` of
        ``cfg.alpha`` at each of the graph's nodes (graphax's
        `init_for_graph`)."""
        linear_init(self.m1, generator)
        linear_init(self.m2, generator)
        self.alpha_train = nn.Parameter(torch.full(
            (graph.num_nodes,), float(self.cfg.alpha),
            device=self.m1.weight.device))
        return self

    def rhs(self, graph: Graph, wb, wb_t, x0, t, x):
        alph = torch.sigmoid(self.alpha_train)[:, None].to(x.dtype)
        ax = spmm(graph, wb, wb_t, x)
        return alph * 0.5 * (ax - x) + x0

    def forward(self, graph: Graph, x, *, train: bool = False,
                generator=None):
        """``graph`` carries the gcn-normalised weights
        (:func:`normalize_for_cgnn`). Returns (logits, ``{"nfe",
        "success"}``); gradients flow through the accepted steps where they
        are recorded (graphax's ``differentiable=train``)."""
        cfg = self.cfg
        x = dropout(x, cfg.input_dropout, train, generator)
        x = linear_apply(self.m1, x)
        x = torch.cat([x, torch.zeros_like(x)], dim=-1)   # always augment
        x0 = x.detach()
        wb = graph.edge_weight.to(x.dtype).contiguous()
        wb_t = transpose_values(graph, wb)
        res = odeint(lambda t, y: self.rhs(graph, wb, wb_t, x0, t, y), x,
                     0.0, float(cfg.time), method=cfg.method, rtol=cfg.rtol,
                     atol=cfg.atol, step_size=cfg.step_size,
                     max_nfe=cfg.max_nfe)
        z = torch.relu(res.y[..., :self.hidden])
        z = dropout(z, cfg.dropout, train, generator)
        return linear_apply(self.m2, z), {"nfe": res.nfe,
                                          "success": res.success}


def make_cgnn(cfg, num_features: int, num_classes: int) -> CGNN:
    """graphax's `make_cgnn`."""
    return CGNN(cfg, num_features, num_classes)


def normalize_for_cgnn(graph: Graph) -> Graph:
    """Symmetric normalisation `get_sym_adj` (`src/utils.py:208-212`): the
    adjacency the CGNN RHS reads."""
    w = gcn_norm_weights(graph.row, graph.col, graph.edge_weight,
                         graph.num_nodes, mask=graph.edge_mask)
    return graph.with_weights(w)
