"""Distance-space utilities and positional-distance rewiring (a copy of
`graphax/rewiring/distances.py`, host numpy). graphax's module is the twin
of `src/distances_kNN.py` (sklearn kNN from features or precomputed
distances + quantile-threshold adjacency — note the reference file is
broken, `len(x)` used as an iterable, SURVEY §8; intent implemented),
`src/hyperbolic_distances.py` (Poincaré-ball pairwise distances), and
`apply_pos_dist_rewire` (`src/graph_rewiring.py:318-375`)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def poincare_distances(emb: np.ndarray, block: int = 2048) -> np.ndarray:
    """Pairwise Poincaré-ball distances
    ``arccosh(1 + 2‖p−q‖² / ((1−‖p‖²)(1−‖q‖²)))``
    (`src/hyperbolic_distances.py:7-18`)."""
    emb = np.asarray(emb, dtype=np.float64)
    n = emb.shape[0]
    sq_norm = np.sum(emb * emb, axis=1)
    denom_i = np.maximum(1.0 - sq_norm, 1e-12)
    out = np.empty((n, n))
    for s in range(0, n, block):
        e = min(s + block, n)
        diff = emb[s:e, None, :] - emb[None, :, :]
        d2 = np.sum(diff * diff, axis=-1)
        arg = 1.0 + 2.0 * d2 / (denom_i[s:e, None] * denom_i[None, :])
        out[s:e] = np.arccosh(np.maximum(arg, 1.0))
    return out


def knn_from_distances(dist: np.ndarray, k: int, exclude_self: bool = True
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """k smallest-distance neighbors per row from a precomputed matrix
    (`src/distances_kNN.py` intent)."""
    d = np.array(dist, dtype=np.float64)
    if exclude_self:
        np.fill_diagonal(d, np.inf)
    idx = np.argpartition(d, k, axis=1)[:, :k]
    row = np.repeat(np.arange(d.shape[0], dtype=np.int64), k)
    return row, idx.reshape(-1).astype(np.int64)


def quantile_threshold_adjacency(dist: np.ndarray, quantile: float
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Keep pairs below the given distance quantile
    (`src/distances_kNN.py` threshold mode / `pos_dist_quantile`)."""
    d = np.array(dist, dtype=np.float64)
    np.fill_diagonal(d, np.inf)
    thresh = np.quantile(d[np.isfinite(d)], quantile)
    row, col = np.nonzero(d <= thresh)
    return row.astype(np.int64), col.astype(np.int64)


def apply_pos_dist_rewire(data, cfg, embeddings: Optional[np.ndarray] = None,
                          space: str = "hyperbolic"):
    """Rebuild edges from positional distances — kNN (``rewire_KNN_k``) or
    quantile threshold (``pos_dist_quantile``)
    (`src/graph_rewiring.py:318-375`)."""
    from graphax_torch.rewiring.knn import rewire_graph_with_edges

    if embeddings is None:
        if data.pos_encoding is None:
            raise ValueError("need embeddings or data.pos_encoding")
        embeddings = data.pos_encoding.cpu().numpy()
    if space == "hyperbolic":
        dist = poincare_distances(embeddings)
    else:
        diff = embeddings[:, None, :] - embeddings[None, :, :]
        dist = np.sqrt(np.sum(diff * diff, axis=-1))
    if cfg.threshold_type == "topk_adj":
        row, col = knn_from_distances(dist, cfg.rewire_KNN_k)
    else:
        row, col = quantile_threshold_adjacency(dist, cfg.pos_dist_quantile)
    g = rewire_graph_with_edges(data.graph, row, col,
                                self_loop_weight=cfg.self_loop_weight,
                                keep_capacity=False)
    return data.with_graph(g)
