"""Host-side (numpy) graph topology construction.

Port of `graphax/sparse/build.py` with the numpy versions of `coalesce`,
`to_undirected` and `add_self_loops` (`graphax/native/__init__.py:83-137`
has the C++ twins; the numpy code is the semantics). Semantics:

- duplicate edges accumulate their weights;
- `add_self_loops` ADDS `fill_value` to the diagonal (an existing self-loop
  weight w becomes w + fill);
- `to_undirected` unions the edge set with its reverse, deduplicated.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from graphax_torch.sparse.graph import Graph
from graphax_torch.utils.device import resolve_device

Edges = Tuple[np.ndarray, np.ndarray, np.ndarray]  # (row, col, weight)

def _as_edges(row, col, weight=None) -> Edges:
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    if weight is None:
        weight = np.ones(row.shape[0], dtype=np.float64)
    else:
        weight = np.asarray(weight, dtype=np.float64)
    return row, col, weight


def _num_nodes(num_nodes, row, col) -> int:
    if num_nodes is not None:
        return int(num_nodes)
    return int(max(row.max(initial=-1), col.max(initial=-1)) + 1)


def coalesce(row, col, weight=None, num_nodes: Optional[int] = None) -> Edges:
    """Sort edges by (row, col) and sum duplicate weights."""
    row, col, weight = _as_edges(row, col, weight)
    n = _num_nodes(num_nodes, row, col)
    key = row * n + col
    uniq, inv = np.unique(key, return_inverse=True)
    w = np.zeros(uniq.shape[0], dtype=np.float64)
    np.add.at(w, inv, weight)
    return (uniq // n).astype(np.int64), (uniq % n).astype(np.int64), w


def add_self_loops(row, col, weight=None, fill_value: float = 1.0,
                   num_nodes: Optional[int] = None) -> Edges:
    """Add `fill_value` to every diagonal entry (creating loops where absent)."""
    row, col, weight = _as_edges(row, col, weight)
    n = _num_nodes(num_nodes, row, col)
    loops = np.arange(n, dtype=np.int64)
    row = np.concatenate([row, loops])
    col = np.concatenate([col, loops])
    weight = np.concatenate([weight, np.full(n, float(fill_value))])
    return coalesce(row, col, weight, n)


def to_undirected(row, col, num_nodes: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Union with the reversed edge set, deduplicated. Weights are dropped."""
    r = np.concatenate([row, col]).astype(np.int64)
    c = np.concatenate([col, row]).astype(np.int64)
    n = _num_nodes(num_nodes, r, c)
    key = np.unique(r * n + c)
    return (key // n).astype(np.int64), (key % n).astype(np.int64)


def remove_self_loops(row, col, weight=None) -> Edges:
    """Drop the diagonal entries (`src/utils.py:44-70`)."""
    row, col, weight = _as_edges(row, col, weight)
    keep = row != col
    return row[keep], col[keep], weight[keep]


def dense_to_edges(adj: np.ndarray) -> Edges:
    """The nonzero entries of a dense adjacency, in row-major order
    (`src/utils.py:78-95`'s intent)."""
    adj = np.asarray(adj)
    row, col = np.nonzero(adj)
    return (row.astype(np.int64), col.astype(np.int64),
            adj[row, col].astype(np.float64))


def full_adjacency(num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """All N^2 (row, col) pairs (`graphax/sparse/build.py:105`)."""
    row = np.repeat(np.arange(num_nodes, dtype=np.int64), num_nodes)
    col = np.tile(np.arange(num_nodes, dtype=np.int64), num_nodes)
    return row, col


def two_hop(row, col, num_nodes: Optional[int] = None
            ) -> Tuple[np.ndarray, np.ndarray]:
    """The edge set of A + A^2, deduplicated, no weights
    (`graphax/sparse/build.py:112`, PyG's `TwoHop`)."""
    import scipy.sparse as sp

    row, col, w = _as_edges(row, col, None)
    n = _num_nodes(num_nodes, row, col)
    a = sp.coo_matrix((np.ones_like(w), (row, col)), shape=(n, n)).tocsr()
    a2 = ((a + a @ a) > 0).tocoo()
    return a2.row.astype(np.int64), a2.col.astype(np.int64)


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def build_graph(row, col, num_nodes: int, edge_weight=None,
                self_loop_weight: float = 0.0, make_undirected: bool = False,
                pad_multiple: int = 128, strategy: str = "auto",
                dense_threshold: int = 20_000, device=None,
                extra_edge_capacity: int = 0) -> Graph:
    """[undirected] -> [self-loops] -> coalesce -> sort by (row, col) -> pad
    to a bucket (``extra_edge_capacity`` more slots first) -> Graph on
    ``device`` (the card unless asked otherwise).

    ``strategy="auto"`` resolves as graphax does: dense when ``num_nodes <=
    dense_threshold`` (`graphax/sparse/build.py:155-156`), sparse otherwise.
    A dense graph keeps its CSR and CSC layouts (the hard block's pin walks
    them); each forward densifies its values once
    (`graphax_torch.kernels.dense_path`). ``"windowed"`` attaches the
    block-dense layout (`:157-162`; node ids should be community-ordered
    first). graphax's ``"edge"`` (its plain edge list, which the
    multimodal chain graphs ask for) is the CSR's ``"sparse"`` here."""
    dev = resolve_device(device)
    if strategy == "auto":
        strategy = "dense" if num_nodes <= dense_threshold else "sparse"
    elif strategy == "edge":
        strategy = "sparse"
    if strategy not in ("dense", "sparse", "windowed"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if make_undirected:
        row, col = to_undirected(row, col, num_nodes)
        edge_weight = None
    if self_loop_weight:
        row, col, edge_weight = add_self_loops(row, col, edge_weight,
                                               self_loop_weight, num_nodes)
    else:
        row, col, edge_weight = coalesce(row, col, edge_weight, num_nodes)
    e = int(row.shape[0])
    cap = round_up(e + int(extra_edge_capacity), pad_multiple)
    g = Graph.from_edges(row, col, num_nodes, edge_weight,
                         edge_buffer_size=cap, device=dev)
    if strategy == "windowed":
        from graphax_torch.kernels.dispatch import attach_windows

        g = attach_windows(g)
    elif strategy == "dense":
        g = dataclasses.replace(g, strategy="dense")
    return g
