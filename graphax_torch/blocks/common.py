"""Shared block machinery: per-forward graph normalisation, the FuncState
and the solver harness (port of `graphax/blocks/common.py`)."""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import torch
from torch.profiler import record_function

from graphax_torch.functions.common import FuncState, prepare_scalars
from graphax_torch.functions.gat import GATFunction, gat_rhs
from graphax_torch.functions.laplacian import laplacian_rhs
from graphax_torch.functions.regularizers import (
    init_reg_states, make_regularized_rhs,
)
from graphax_torch.functions.transformer import (
    TransformerFunction, transformer_rhs,
)
from graphax_torch.kernels.spmm import transpose_values
from graphax_torch.kernels.windowed_spmm import densify_windows
from graphax_torch.kernels.dense_path import (
    dense_adjacency_mask, densify, use_dense_attention,
)
from graphax_torch.ode import ODEResult, Observer, odeint, odeint_adjoint
from graphax_torch.sparse.graph import Graph
from graphax_torch.sparse.ops import gcn_norm_weights, rw_norm_weights


class BlockOutput(NamedTuple):
    z: torch.Tensor
    result: ODEResult
    reg_states: tuple = ()


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


def make_fstate(graph: Graph, x: torch.Tensor, attention=None, *,
                train: bool, cfg=None) -> FuncState:
    """The per-forward FuncState: edge values cast to the state dtype and
    permuted to the CSC order once here, not at every solver evaluation.
    On a dense graph the values become the ``[N, N]`` operator here, once
    per forward (`graphax/blocks/common.py:64-68`), or for the transformer
    RHS the adjacency mask (where its dense route runs).
    On a windowed graph (`graphax/blocks/common.py:76-100`) the in-window
    values become the dense blocks here, and the residual values go in its
    CSR and CSC slot orders; for the transformer RHS only the blocks, and
    only where K5's route or the windowed twin reweights with them
    (graphax's ``fstate.wb[0]``, `graphax/functions/transformer.py:
    287-288`). ``train`` is graphax's argument; the transformer RHS takes
    the same route in either mode (`graphax_torch.functions.transformer.
    attention_route`).

    A pin that carries a gradient (the attention and mixed blocks in
    training) passes it on through the operator: `densify`'s index_put on
    a dense graph, the windowed blocks' `densify_windows` and the residual
    values on a windowed one, ``wb`` on a sparse one. The transposed
    values ``wb_t`` feed only the product's backward (``dx = A^T g``), so
    they are detached: the values' gradient is the SDDMM's, and the
    adjoint carries no a_p for them (graphax's state off its tiled layout
    has no such leaf)."""
    values = graph.edge_weight if attention is None else attention
    pinned = attention is not None
    if cfg is not None and cfg.function == "GAT":
        # GAT reads the graph alone: its attention is recomputed at every
        # evaluation
        return FuncState(graph=graph, x0=x.detach(), pinned=pinned)
    nl = cfg is not None and cfg.function == "transformer"
    if graph.strategy == "dense":
        if nl:
            # GRAND-nl reads the adjacency mask at every evaluation, not an
            # operator (graphax densifies the weights here all the same)
            mask = dense_adjacency_mask(graph) \
                if use_dense_attention(graph, cfg.heads) else None
            return FuncState(graph=graph, x0=x.detach(), pinned=pinned,
                             mask=mask)
        return FuncState(graph=graph, x0=x.detach(),
                         dense=densify(graph, values), pinned=pinned)
    if graph.strategy == "windowed":
        wl = graph.windows
        if nl:
            windowed = cfg.attention_norm_idx == 0 and not cfg.mix_features
            dense = densify_windows(values, wl, x.dtype) \
                if cfg.reweight_attention and windowed else None
            return FuncState(graph=graph, x0=x.detach(), dense=dense,
                             pinned=pinned)
        v = values.to(x.dtype)
        return FuncState(graph=graph, x0=x.detach(),
                         wb=v[wl.residual.perm].contiguous(),
                         wb_t=v.detach()[wl.residual_t.perm].contiguous(),
                         dense=densify_windows(values, wl, x.dtype),
                         pinned=pinned)
    wb = values.to(x.dtype).contiguous()
    return FuncState(graph=graph, x0=x.detach(), wb=wb,
                     wb_t=transpose_values(graph, wb.detach()), pinned=pinned)


def _windowed_zero_leaves(g: Graph, blocks_read: bool,
                          residual_read: bool) -> int:
    """graphax's adjoint leaves on the windowed layout that the port does
    not carry (`graphax/blocks/common.py:71-97`): its blocked residual
    tables (``res_t``, never read; ``res``, of which the port carries the
    slots where the RHS reads them, the padding never) and, where the RHS
    does not read them, the dense blocks."""
    wl = g.windows
    res, res_t = wl.graphax_residual_slots
    zero = res_t + res - (wl.residual.num_slots if residual_read else 0)
    if not blocks_read:
        zero += wl.num_tiles * wl.tile * wl.window
    return zero


def integrate(cfg, func, fstate: FuncState, x, *, train: bool,
              t1: Optional[float] = None, observer: Optional[Observer] = None,
              max_steps: Optional[int] = None,
              augment: Optional[Callable] = None) -> BlockOutput:
    """Run the solve as the reference blocks invoke torchdiffeq
    (`src/block_constant.py:27-58`): the adjoint integrator when
    ``cfg.adjoint and train``, the plain one otherwise (autograd through the
    accepted steps when gradients are enabled). ``observer`` is seen on the
    plain path only (the early-stop evaluation), as in graphax.

    In training with regularisers (``cfg.reg_coeffs()``) the state is
    ``(x, *reg_states)`` and the RHS `make_regularized_rhs`'s, on either
    path (`graphax/blocks/common.py:179-217`); ``reg_states`` of the output
    holds their values at T. Every regulariser but kinetic_energy takes the
    RHS's vjp inside the RHS, so the loss is differentiated through a
    derivative of it: ``fstate`` is then flagged ``second_order`` (the
    transformer RHS leaves the kernel routes whose backward has no
    derivative). ``augment`` maps the RHS ``f(t, x)`` to the RHS of a
    tuple state ``x`` (graphax's ``rhs_override``, the higher-order
    block's order reduction); ``z`` is then that tuple."""
    t_end = float(cfg.time if t1 is None else t1)
    state_dtype = x[0].dtype if isinstance(x, tuple) else x.dtype
    alpha, beta = prepare_scalars(func, cfg, state_dtype)
    names = tuple(n for n, _ in cfg.reg_coeffs()) if train else ()
    if any(n != "kinetic_energy" for n in names):
        fstate = dataclasses.replace(fstate, second_order=True)
    g = fstate.graph
    state0 = x
    if names:
        if isinstance(x, tuple):
            raise TypeError("the regularised RHS takes a one-tensor state, "
                            "as graphax's (`make_regularized_rhs`)")
        state0 = (x, *init_reg_states(g.num_nodes, names, x.dtype, x.device))

    def wrap(rhs):
        """The RHS of the solver's state from the function's ``rhs(t, x)``."""
        if augment is not None:
            rhs = augment(rhs)
        if names:
            rhs = make_regularized_rhs(rhs, names)
        return rhs

    common = dict(method=cfg.method, rtol=cfg.rtol, atol=cfg.atol,
                  step_size=cfg.step_size, max_nfe=cfg.max_nfe,
                  max_steps=max_steps)
    if cfg.adjoint and train:
        # graphax's adjoint state (`_split_diff_state`) holds the a_p of
        # alpha_eff, beta_eff, x0, the edge weights and every parameter of
        # the RHS, which the port integrates under an adaptive method even
        # where it discards them; its leaves that stay zero are counted:
        # the RHS module's parameters it does not track (alpha_train and
        # beta_train, which the RHS reads only as alpha and beta above; the
        # attention layer's V and Wout outside mix_features, GAT's Wout
        # likewise), and the edge weights where the RHS does not read them
        # (pinned attention, the transformer, GAT). On a dense graph it
        # holds dense_adj, the [N, N] operator: the Laplacian RHS reads it
        # (the port integrates its a_p in f32 as well, and the edge weights
        # and a pin's attention stay zero); the transformer and GAT RHS do
        # not, so its N^2 leaves stay zero. On a windowed graph it holds
        # the dense blocks and the blocked residual tables
        # (`_windowed_zero_leaves`): the Laplacian RHS reads the blocks
        # (their a_p is `win_bwd_dense`'s at every backward NFE) and the
        # residual values, the transformer the blocks under reweight.
        zero = sum(p.numel() for p in func.parameters())
        if isinstance(func, (TransformerFunction, GATFunction)):
            att = func.adjoint_tensors()
            params = (alpha, beta, fstate.x0, *att)
            if fstate.dense is not None:
                params += (fstate.dense,)       # the windowed reweight
            track = (True,) * len(params)
            zero += g.edge_buffer_size - sum(p.numel() for p in att)
            zero += g.edge_buffer_size if fstate.pinned else 0
            if g.strategy == "dense":
                zero += g.num_nodes ** 2        # graphax's dense_adj
            elif g.strategy == "windowed":
                zero += _windowed_zero_leaves(g, fstate.dense is not None,
                                              False)
            if isinstance(func, GATFunction):
                rhs = gat_rhs
            else:
                rhs = functools.partial(transformer_rhs, mask=fstate.mask,
                                        second_order=fstate.second_order)
            # the transformer's reweight reads the edge weights
            reweight = isinstance(func, TransformerFunction) \
                and cfg.reweight_attention
            if reweight:
                params += (g.edge_weight,)
                track += (True,)
                zero -= g.edge_buffer_size

            def base(p, t, y):
                if reweight:
                    return rhs(cfg, g.with_weights(p[-1]), p[:-1], y)
                return rhs(cfg, g, p, y)
        elif g.strategy == "dense":
            params = (alpha, beta, fstate.x0, fstate.dense)
            track = (True,) * len(params)
            zero += g.edge_buffer_size * (2 if fstate.pinned else 1)

            def base(p, t, y):
                return laplacian_rhs(cfg, g, *p[:3], None, None, y,
                                     dense=p[3])
        else:
            params = (alpha, beta, fstate.x0, fstate.wb, fstate.wb_t)
            track = (True, True, True, True, False)
            zero += g.edge_buffer_size if fstate.pinned else 0
            if g.strategy == "windowed":
                params += (fstate.dense,)
                track += (True,)
                zero += g.edge_buffer_size + _windowed_zero_leaves(g, True,
                                                                   True)

            def base(p, t, y):
                return laplacian_rhs(cfg, g, *p[:5], y,
                                     dense=p[5] if len(p) > 5 else None)

        def f_adj(p, t, y):
            return wrap(lambda tt, yy: base(p, tt, yy))(t, y)

        with record_function("graphax_torch.solve"):
            res = odeint_adjoint(
                f_adj, params, state0, 0.0, t_end,
                adjoint_method=cfg.adjoint_method,
                adjoint_rtol=cfg.rtol_adjoint, adjoint_atol=cfg.atol_adjoint,
                adjoint_step_size=cfg.adjoint_step_size,
                track=track,
                zero_leaves=zero, **common)
    else:
        call = wrap(lambda t, y: func.rhs(alpha, beta, fstate, t, y))
        with record_function("graphax_torch.solve"):
            res = odeint(call, state0, 0.0, t_end, observer=observer,
                         **common)
    if names:
        return BlockOutput(z=res.y[0], result=res, reg_states=res.y[1:])
    return BlockOutput(z=res.y, result=res)
