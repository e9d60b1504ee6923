"""Attaching the windowed layout to a graph (port of `attach_windows`,
`graphax/kernels/dispatch.py:65-87`), and the per-edge attention ops of the
plain transformer path (`:98-143`).

graphax routes its segment softmax, squareplus and attention SpMM between
XLA segment ops and one-hot reductions over its TPU row tiles; neither is a
Pallas kernel, and both give the same numbers, so the port runs the plain
segment ops (`graphax_torch.sparse.ops`) on either device. The dense
strategy's operators are in `graphax_torch.kernels.dense_path`."""

from __future__ import annotations

import dataclasses

import torch

from graphax_torch.kernels.windows import build_window_tiles
from graphax_torch.sparse import ops


def attach_windows(graph, window: int = 512, tile: int = 128):
    """A copy of ``graph`` carrying the windowed layout, with
    ``strategy="windowed"``. Host-side; node ids should be community-ordered
    first (`graphax_torch.data.reorder.community_reorder` does both)."""
    e = graph.num_edges
    wl = build_window_tiles(graph.row[:e].cpu().numpy(),
                            graph.col[:e].cpu().numpy(), graph.num_nodes,
                            tile=tile, window=window, device=graph.device)
    return dataclasses.replace(graph, windows=wl, strategy="windowed")


def segment_softmax_auto(graph, scores, norm_index_is_row: bool, mask=None):
    """Softmax of ``scores [E_pad, H]`` over the rows' (or the columns')
    edges."""
    index = graph.row if norm_index_is_row else graph.col
    return ops.segment_softmax(scores, index, graph.num_nodes, mask=mask)


def squareplus_auto(graph, scores, norm_index_is_row: bool, mask=None):
    """Square-plus normalisation (global max shift) over rows or columns."""
    index = graph.row if norm_index_is_row else graph.col
    return ops.squareplus_norm(scores, index, graph.num_nodes, mask=mask)


def attention_spmm_auto(graph, attention, x, mask=None):
    """``A x`` with the head-mean of ``attention [E_pad, H]`` as A's values."""
    mean_att = attention.mean(dim=1)
    if mask is not None:
        mean_att = torch.where(mask, mean_att, torch.zeros_like(mean_att))
    return ops.spmm(graph.row, graph.col, mean_att, x, graph.num_nodes)


def spmm_multihead_auto(graph, attention, v):
    """``[N, H, Dh]``: each head's ``A_h v_h`` with ``attention [E_pad, H]``
    as the heads' values (0 on padding)."""
    return ops.spmm_multihead(graph.row, graph.col, attention, v,
                              graph.num_nodes)
