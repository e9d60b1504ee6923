"""Community reordering of a dataset for the windowed SpMM strategy (port of
`graphax/data/reorder.py:30-91`).

``community_reorder`` relabels node ids so that nodes of one community (the
native region-growing partition, capacity ``window``) occupy a contiguous
id range, rebuilds the graph on the new ids and attaches the windowed
layout (`graphax_torch.kernels.windows`). The reordered dataset is the same
task up to a node permutation: features, labels and split masks follow the
edge endpoints, and so do Beltrami's positional encodings
(`graphax/data/reorder.py:91`). Host-side, once per dataset."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graphax_torch.data.container import GraphData
from graphax_torch.kernels.dispatch import attach_windows
from graphax_torch.kernels.windows import community_order
from graphax_torch.sparse.graph import Graph


def community_reorder(data: GraphData, window: int = 512, tile: int = 128,
                      min_in_window_frac: float = 0.0) -> GraphData:
    """``data`` with community-contiguous node ids and
    ``graph.strategy == "windowed"``.

    If fewer than ``min_in_window_frac`` of the edges land in-window after
    reordering (a graph without community structure), the node ids stay
    reordered but the graph keeps the plain CSR strategy. graphax attaches
    its TPU row tiles and hub layout there; the port has neither."""
    tile = min(tile, window)  # the layout requires tile | window
    g = data.graph
    n, e = g.num_nodes, g.num_edges
    row = g.row[:e].cpu().numpy()
    col = g.col[:e].cpu().numpy()
    weight = g.edge_weight[:e].cpu().numpy()

    perm = community_order(row, col, n, window=window)    # perm[old] = new
    r2, c2 = perm[row], perm[col]
    order = np.lexsort((c2, r2))
    graph = Graph.from_edges(r2[order], c2[order], n, weight[order],
                             edge_buffer_size=g.edge_buffer_size,
                             device=g.device)
    windowed = attach_windows(graph, window=window, tile=tile)
    if not (min_in_window_frac > 0 and e > 0 and
            windowed.windows.in_window_edges / e < min_in_window_frac):
        graph = windowed

    inv = torch.as_tensor(np.argsort(perm), device=data.x.device)
    return dataclasses.replace(
        data, graph=graph, x=data.x[inv], y=data.y[inv],
        train_mask=data.train_mask[inv], val_mask=data.val_mask[inv],
        test_mask=data.test_mask[inv],
        pos_encoding=None if data.pos_encoding is None
        else data.pos_encoding[inv.to(data.pos_encoding.device)])
