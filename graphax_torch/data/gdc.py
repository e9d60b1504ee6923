"""Graph Diffusion Convolution (GDC) preprocessing and positional encodings
(a copy of `graphax/data/gdc.py`, which imports no JAX: the port keeps its
own). graphax's module is the twin of `apply_gdc`/`GDCWrapper`
(`src/graph_rewiring.py:42-81,378-434`) and the DIGL-paper exact kernels
(`src/graph_datasets/DIGL_data.py:126-161`):

- exact PPR matrix  α·(I − (1−α)·T)⁻¹  with T the rw transition matrix;
- heat kernel       expm(−t·(I − T));
- sparsification by per-column top-k or global threshold;
- the dense diffusion matrix doubles as the GDC positional encoding
  (row or column orientation), NMF-compressed for large graphs
  (`src/pos_enc_factorisation.py`).

These are offline/preprocessing ops — NumPy/SciPy on host by design.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _transition_matrix(row, col, num_nodes: int, norm: str = "sym"
                       ) -> np.ndarray:
    a = np.zeros((num_nodes, num_nodes))
    np.add.at(a, (np.asarray(row), np.asarray(col)), 1.0)
    deg = a.sum(axis=1)
    deg_inv = np.divide(1.0, deg, out=np.zeros_like(deg), where=deg > 0)
    if norm == "rw":
        return deg_inv[:, None] * a
    d_is = np.sqrt(deg_inv)
    return d_is[:, None] * a * d_is[None, :]


def exact_ppr_matrix(row, col, num_nodes: int, alpha: float = 0.05,
                     norm: str = "sym", add_self_loops: bool = True
                     ) -> np.ndarray:
    """α·(I − (1−α)·T)⁻¹ (`DIGL_data.py:126-134`)."""
    if add_self_loops:
        row = np.concatenate([row, np.arange(num_nodes)])
        col = np.concatenate([col, np.arange(num_nodes)])
    t = _transition_matrix(row, col, num_nodes, norm)
    return alpha * np.linalg.inv(np.eye(num_nodes) - (1 - alpha) * t)


def heat_kernel_matrix(row, col, num_nodes: int, t: float = 3.0,
                       norm: str = "sym", add_self_loops: bool = True
                       ) -> np.ndarray:
    """expm(−t·(I − T)) (`DIGL_data.py:136-144`)."""
    from scipy.linalg import expm

    if add_self_loops:
        row = np.concatenate([row, np.arange(num_nodes)])
        col = np.concatenate([col, np.arange(num_nodes)])
    tm = _transition_matrix(row, col, num_nodes, norm)
    return expm(-t * (np.eye(num_nodes) - tm))


def topk_per_column(mat: np.ndarray, k: int) -> np.ndarray:
    """Keep the k largest entries in each column, zero the rest
    (`DIGL_data.py:146-153`)."""
    m = mat.copy()
    if k >= m.shape[0]:
        return m
    idx = np.argpartition(m, -k, axis=0)[:-k]
    np.put_along_axis(m, idx, 0.0, axis=0)
    return m


def threshold_sparsify(mat: np.ndarray, eps: float) -> np.ndarray:
    """Zero entries below eps (`DIGL_data.py:155-161`)."""
    m = mat.copy()
    m[m < eps] = 0.0
    return m


def threshold_from_avg_degree(mat: np.ndarray, avg_degree: int) -> float:
    """Pick the threshold that retains ~avg_degree·N entries
    (PyG GDC's `__calculate_eps__` behavior used via `gdc_avg_degree`)."""
    n = mat.shape[0]
    k = min(avg_degree * n, mat.size - 1)
    return float(np.sort(mat.ravel())[-k - 1])


def gdc_diffusion(row, col, num_nodes: int, *, method: str = "ppr",
                  alpha: float = 0.05, heat_time: float = 3.0,
                  sparsification: str = "topk", k: int = 64,
                  eps: Optional[float] = 1e-4,
                  avg_degree: Optional[int] = None,
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Full GDC pipeline (`apply_gdc`, `src/graph_rewiring.py:42-81`):
    diffuse → sparsify → rw-normalize columns. Returns
    (new_row, new_col, new_weight, dense_diffusion_for_pos_enc)."""
    if method == "ppr":
        diff = exact_ppr_matrix(row, col, num_nodes, alpha)
    elif method == "heat":
        diff = heat_kernel_matrix(row, col, num_nodes, heat_time)
    else:
        raise ValueError(f"unknown gdc method {method!r}")

    if sparsification == "topk":
        kept = topk_per_column(diff, k)
    elif sparsification == "threshold":
        if eps is None:
            if avg_degree is None:
                raise ValueError("threshold sparsification needs eps or "
                                 "avg_degree")
            eps = threshold_from_avg_degree(diff, avg_degree)
        kept = threshold_sparsify(diff, eps)
    else:
        raise ValueError(f"unknown sparsification {sparsification!r}")

    # column-wise rw normalization (PyG GDC transition_matrix 'col')
    colsum = kept.sum(axis=0, keepdims=True)
    kept_norm = np.divide(kept, colsum, out=np.zeros_like(kept),
                          where=colsum > 0)
    r, c = np.nonzero(kept_norm)
    return r.astype(np.int64), c.astype(np.int64), kept_norm[r, c], diff


def gdc_pos_encoding(row, col, num_nodes: int, *, orientation: str = "row",
                     embedding_dim: Optional[int] = None, seed: int = 0,
                     **gdc_kwargs) -> np.ndarray:
    """GDC positional encoding: the dense diffusion matrix (or its transpose
    for `pos_enc_orientation='col'`), optionally NMF-compressed to
    `embedding_dim` for large graphs (`src/pos_enc_factorisation.py:39-66`)."""
    _, _, _, diff = gdc_diffusion(row, col, num_nodes, **gdc_kwargs)
    enc = diff if orientation == "row" else diff.T
    if embedding_dim is not None and embedding_dim < num_nodes:
        enc = nmf_compress(enc, embedding_dim, seed=seed)
    return enc


def nmf_compress(mat: np.ndarray, dim: int, seed: int = 0,
                 iters: int = 200) -> np.ndarray:
    """Nonnegative matrix factorization W·H ≈ M, returning W [N, dim] — the
    capability of `pos_enc_factorisation.py` without the sklearn dependency:
    multiplicative-update NMF on the clipped-nonnegative matrix."""
    rng = np.random.RandomState(seed)
    m = np.maximum(mat, 0.0) + 1e-12
    n, d = m.shape
    w = np.abs(rng.randn(n, dim)) + 0.1
    h = np.abs(rng.randn(dim, d)) + 0.1
    for _ in range(iters):
        h *= (w.T @ m) / (w.T @ w @ h + 1e-12)
        w *= (m @ h.T) / (w @ h @ h.T + 1e-12)
    return w.astype(np.float32)
