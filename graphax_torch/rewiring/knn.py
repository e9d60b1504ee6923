"""k-nearest-neighbour graph rewiring, the BLEND graph-evolution path (port
of `graphax/rewiring/knn.py`).

The all-pairs sweep runs in blocks of rows on the embedding's device:
``|x_i|^2 + |x_j|^2 - 2 x_i . x_j`` with the cross term one matrix product,
then ``torch.topk`` of the negated distances. graphax has no Pallas kernel
here (it uses `lax.top_k` on every backend), so plain PyTorch is its route.
``lax.top_k`` breaks ties by the lower index; ``torch.topk`` promises no
order among equal values, so on a row whose k-th and (k+1)-th distances
tie the two may keep different, equally near, neighbours.

The reference's quirks, kept: all-zero rows move to coordinates 1e30 so
that no other node picks them; each node gives k out-edges (row = node,
col = neighbour, the node itself included, as argKmin); ``sym`` adds the
reverse edges. The new edge list becomes a fresh Graph on the host."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from graphax_torch.sparse import build
from graphax_torch.sparse.graph import Graph


def knn_distances(x: torch.Tensor, k: int, block_size: int = 4096
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``[N, k]`` distances, ``[N, k]`` int64 neighbours) of every row of
    ``x [N, D]``, nearest first, computed on x's device in x's dtype."""
    n = x.shape[0]
    zero_rows = (x == 0).all(-1)
    x = torch.where(zero_rows[:, None], torch.full_like(x, 1e30), x)
    sq = (x * x).sum(-1)
    dists, idx = [], []
    for start in range(0, n, block_size):
        xb = x[start:start + block_size]
        d = sq[start:start + block_size, None] + sq[None, :] \
            - 2.0 * (xb @ x.T)
        v, i = torch.topk(-d, k, dim=1)
        dists.append(-v)
        idx.append(i)
    return torch.cat(dists), torch.cat(idx)


def knn_graph(x, k: int, *, sym: bool = False, block_size: int = 4096
              ) -> Tuple[np.ndarray, np.ndarray]:
    """The top-k nearest neighbours of every row of ``x`` (a tensor on any
    device, or numpy). Returns host (row, col) int64."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    _, idx = knn_distances(x, k, block_size)
    col = idx.cpu().numpy().reshape(-1).astype(np.int64)
    row = np.repeat(np.arange(n, dtype=np.int64), k)
    if sym:
        row, col = build.to_undirected(row, col, n)
    return row.astype(np.int64), col.astype(np.int64)


def rewire_graph_with_edges(graph: Graph, row, col,
                            self_loop_weight: float = 0.0,
                            keep_capacity: bool = True) -> Graph:
    """A Graph on ``graph``'s device with the new topology: coalesced (or
    with ``self_loop_weight`` added to the diagonal), the old edge buffer
    kept where the new edges fit and ``keep_capacity``, else the next
    multiple of 128.

    The strategy stays, as graphax's: dense stays dense, sparse sparse. A
    windowed graph comes back without windows in graphax, whose RHS then
    takes its gather SpMM over the edge list (`graphax/functions/
    laplacian.py:66`) and its attention the per-edge path; the port's
    counterpart of that route is its CSR strategy, so such a graph comes
    back ``"sparse"`` (the windows are not rebuilt: the new edges ignore
    the community order)."""
    if self_loop_weight:
        row, col, w = build.add_self_loops(row, col, None, self_loop_weight,
                                           graph.num_nodes)
    else:
        row, col, w = build.coalesce(row, col, None, graph.num_nodes)
    e = len(row)
    cap = graph.edge_buffer_size if (keep_capacity
                                     and e <= graph.edge_buffer_size) \
        else build.round_up(e, 128)
    g2 = Graph.from_edges(row, col, graph.num_nodes, w, edge_buffer_size=cap,
                          device=graph.device)
    strategy = "sparse" if graph.strategy == "windowed" else graph.strategy
    return dataclasses.replace(g2, strategy=strategy)


@torch.no_grad()
def _embed(cfg, model, data, feat=None):
    """The kNN embedding of `apply_KNN`: the raw features (``"raw"``), the
    encoder's output (``"T0"``) or the ODE's (``"TN"``), in evaluation
    mode."""
    feat = data.x if feat is None else feat
    if cfg.rewire_KNN_T == "raw":
        return feat
    model.eval()
    if cfg.rewire_KNN_T == "T0":
        return model.encode(feat, train=False,
                            pos_encoding=data.pos_encoding)
    if cfg.rewire_KNN_T == "TN":
        return model.forward_ode(data.graph, feat, train=False,
                                 pos_encoding=data.pos_encoding)[0]
    raise ValueError(f"rewire_KNN_T must be raw|T0|TN, got "
                     f"{cfg.rewire_KNN_T!r}")


def apply_knn(cfg, model, data, *, x=None) -> Graph:
    """`apply_KNN` (`graphax/rewiring/knn.py:86-106`): embed, then the
    ``rewire_KNN_k`` nearest neighbours as the new graph. Returns the new
    Graph (its weights not normalised yet)."""
    z = _embed(cfg, model, data, x)
    row, col = knn_graph(z, cfg.rewire_KNN_k, sym=cfg.rewire_KNN_sym)
    return rewire_graph_with_edges(data.graph, row, col,
                                   self_loop_weight=cfg.self_loop_weight)
