"""Largest-connected-component extraction (port of `graphax/data/lcc.py`).

scipy's weak `connected_components` (union-find in C), as graphax's
fallback route. Its labels number the components in the order of their
lowest node id, so `argmax` of the sizes keeps, on a tie, the component
that holds the lowest node id: the component graphax's native `gx_lcc`
keeps too (`graphax/native/graphbuild.cpp:95-125`, the first root in id
order with the largest size)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components


def largest_connected_component(row, col, num_nodes: int
                                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (keep_nodes [sorted original ids], new_row, new_col) for the
    largest weakly-connected component, with edges remapped to [0, n_lcc).
    A graph of one component comes back as ``arange(N)`` with its edges
    untouched."""
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    adj = sp.coo_matrix((np.ones(len(row)), (row, col)),
                        shape=(num_nodes, num_nodes))
    n_comp, labels = connected_components(adj, directed=True,
                                          connection="weak")
    if n_comp == 1:
        return np.arange(num_nodes), row, col
    keep = np.where(labels == np.bincount(labels).argmax())[0]
    mapper = np.full(num_nodes, -1, dtype=np.int64)
    mapper[keep] = np.arange(keep.shape[0])
    edge_keep = (mapper[row] >= 0) & (mapper[col] >= 0)
    return keep, mapper[row[edge_keep]], mapper[col[edge_keep]]
