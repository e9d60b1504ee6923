"""Shared block machinery: per-forward graph normalisation, the FuncState
and the solver harness (port of `graphax/blocks/common.py`)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from graphax_torch.functions.common import FuncState, prepare_scalars
from graphax_torch.functions.laplacian import laplacian_rhs
from graphax_torch.kernels.spmm import transpose_values
from graphax_torch.ode import ODEResult, odeint, odeint_adjoint
from graphax_torch.sparse.graph import Graph
from graphax_torch.sparse.ops import gcn_norm_weights, rw_norm_weights


class BlockOutput(NamedTuple):
    z: torch.Tensor
    result: ODEResult


def normalize_graph(cfg, graph: Graph) -> Graph:
    """Per-forward weight normalisation, the twin of `reset_graph_data`
    (`src/base_classes.py:70-90`). The topology already holds self-loops of
    weight ``cfg.self_loop_weight``; the fork adds ``self_loop_weight`` to
    the diagonal AGAIN after normalising (`:84-86`), reproduced here. A
    ``pre_normalized`` graph is returned as is."""
    if graph.pre_normalized:
        return graph
    mask = graph.edge_mask
    if cfg.data_norm == "rw":
        w = rw_norm_weights(graph.row, graph.col, graph.edge_weight,
                            graph.num_nodes, norm_dim=1, mask=mask)
    else:
        w = gcn_norm_weights(graph.row, graph.col, graph.edge_weight,
                             graph.num_nodes, mask=mask)
    if cfg.self_loop_weight > 0:
        loop = mask & (graph.row == graph.col)
        w = w + torch.where(loop, torch.full_like(w, cfg.self_loop_weight),
                            torch.zeros_like(w))
    return graph.with_weights(w)


def make_fstate(graph: Graph, x: torch.Tensor, attention=None) -> FuncState:
    """The per-forward FuncState: edge values cast to the state dtype and
    permuted to the CSC order once here, not at every solver evaluation."""
    if graph.strategy != "sparse":
        raise NotImplementedError(f"strategy {graph.strategy!r} is not ported")
    values = graph.edge_weight if attention is None else attention
    wb = values.to(x.dtype).contiguous()
    return FuncState(graph=graph, x0=x.detach(), wb=wb,
                     wb_t=transpose_values(graph, wb))


def integrate(cfg, func, fstate: FuncState, x: torch.Tensor, *, train: bool,
              t1: Optional[float] = None) -> BlockOutput:
    """Run the solve as the reference blocks invoke torchdiffeq
    (`src/block_constant.py:27-58`): the adjoint integrator when
    ``cfg.adjoint and train``, the plain one otherwise (autograd through the
    accepted steps when gradients are enabled)."""
    if train and cfg.reg_coeffs():
        raise NotImplementedError("regularised RHS are not ported yet "
                                  "(ROADMAP Queue 1, M8)")
    t_end = float(cfg.time if t1 is None else t1)
    alpha, beta = prepare_scalars(func, cfg, x.dtype)
    common = dict(method=cfg.method, rtol=cfg.rtol, atol=cfg.atol,
                  step_size=cfg.step_size, max_nfe=cfg.max_nfe)
    g = fstate.graph
    if cfg.adjoint and train:
        def f_adj(p, t, y):
            return laplacian_rhs(cfg, g, *p, y)

        with record_function("graphax_torch.solve"):
            res = odeint_adjoint(
                f_adj, (alpha, beta, fstate.x0, fstate.wb, fstate.wb_t), x,
                0.0, t_end, adjoint_method=cfg.adjoint_method,
                adjoint_rtol=cfg.rtol_adjoint, adjoint_atol=cfg.atol_adjoint,
                adjoint_step_size=cfg.adjoint_step_size, **common)
    else:
        with record_function("graphax_torch.solve"):
            res = odeint(lambda t, y: func.rhs(alpha, beta, fstate, t, y), x,
                         0.0, t_end, **common)
    return BlockOutput(z=res.y, result=res)
