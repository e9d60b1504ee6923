"""Padded graph container, host-side construction and plain sparse ops."""

from graphax_torch.sparse.build import (
    add_self_loops, build_graph, coalesce, dense_to_edges, remove_self_loops,
    to_undirected,
)
from graphax_torch.sparse.graph import Graph, Layout
from graphax_torch.sparse.ops import (
    EPS, attention_spmm, gcn_norm_weights, rw_norm_weights, sddmm_dot,
    segment_max, segment_mean, segment_softmax, segment_sum, spmm,
)
from graphax_torch.sparse.quantile import refined_masked_quantile

__all__ = [
    "EPS", "Graph", "Layout", "add_self_loops", "attention_spmm",
    "build_graph", "coalesce", "dense_to_edges", "gcn_norm_weights",
    "refined_masked_quantile", "remove_self_loops", "rw_norm_weights",
    "sddmm_dot", "segment_max", "segment_mean", "segment_softmax",
    "segment_sum", "spmm", "to_undirected",
]
