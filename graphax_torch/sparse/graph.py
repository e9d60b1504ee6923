"""Padded sparse graph of tensors with host-built CSR and CSC layouts.

Port of `graphax/sparse/graph.py`. Conventions (the reference's A[row, col]):

- ``row`` is the aggregation target of the SpMM: for ``y = A @ x``,
  ``y[i] = sum over edges e with row[e] == i of w[e] * x[col[e]]``;
- ``col`` is the node gathered from;
- real edges fill a prefix of the buffers, sorted by (row, col); padded slots
  have ``row = col = 0`` and weight 0, so weighted sums need no branch, and
  score-space ops (softmax, quantile) apply ``edge_mask`` explicitly.

Instead of graphax's TPU row tiles the GPU layout is:

- CSR: ``row_ptr`` over the sorted buffer (``csr``);
- CSC: a column permutation of the real edges plus ``col_ptr`` (``csc``),
  built in numpy the way ``perm_from_row`` is in
  `graphax/kernels/dispatch.py:37-61`. It serves ``A^T g``.

A graph of ``strategy="windowed"`` also carries the block-dense windowed
layout (``windows``, `graphax_torch.kernels.windows.WindowLayout`), which
the laplacian SpMM uses; every other op keeps the CSR and CSC layouts. On a
graph of ``strategy="dense"`` the RHS works on ``[N, N]`` operators that
each forward densifies (`graphax_torch.kernels.dense_path`); the hard
block's pin still walks the CSR layout.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


class Layout(NamedTuple):
    """One compressed view of the real edges, as the kernels walk it.

    ``ptr [n+1]`` delimits each destination's slots; slot ``j`` gathers from
    ``idx[j]`` into ``seg[j]``. ``perm`` maps slots to edge-buffer positions
    (None for CSR, whose slots are the buffer prefix itself)."""

    ptr: torch.Tensor     # [n + 1] int32
    seg: torch.Tensor     # [E] int64, destination of each slot
    idx: torch.Tensor     # [E] int32, source gathered by each slot
    perm: torch.Tensor | None  # [E] int64 slot -> edge position, or None

    @property
    def num_rows(self) -> int:
        return int(self.ptr.shape[0]) - 1

    @property
    def num_slots(self) -> int:
        return int(self.idx.shape[0])


def _ptr(keys: np.ndarray, n: int) -> np.ndarray:
    counts = np.bincount(keys, minlength=n) if keys.size else np.zeros(n, np.int64)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def build_layouts(row: np.ndarray, col: np.ndarray, num_nodes: int,
                  device) -> tuple:
    """CSR and CSC layouts of the real edges ``row``/``col`` (sorted by
    (row, col)); every tensor contiguous, whatever the strides of ``row``
    and ``col`` (``np.nonzero`` of a matrix gives strided views), since
    the kernels read ``seg`` and ``idx`` as flat arrays."""
    row = np.ascontiguousarray(row, np.int64)
    col = np.ascontiguousarray(col, np.int64)
    if row.size > 1:
        key = row * max(num_nodes, 1) + col
        if np.any(key[1:] < key[:-1]):
            raise ValueError("edges must be sorted by (row, col)")
    if row.size and (row.max() >= num_nodes or col.max() >= num_nodes):
        raise ValueError("edge index out of range")
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    csr = Layout(ptr=as_t(_ptr(row, num_nodes), torch.int32),
                 seg=as_t(row, torch.int64), idx=as_t(col, torch.int32),
                 perm=None)
    perm = np.lexsort((row, col))          # by col, then row
    csc = Layout(ptr=as_t(_ptr(col, num_nodes), torch.int32),
                 seg=as_t(col[perm], torch.int64),
                 idx=as_t(row[perm], torch.int32),
                 perm=as_t(perm, torch.int64))
    return csr, csc


@dataclasses.dataclass(frozen=True)
class Graph:
    """A padded, static-shape sparse graph on one device.

    Attributes:
      row, col: ``[E_pad]`` int64 edge indices (padding 0).
      edge_weight: ``[E_pad]`` float32 (0 on padding).
      num_edges: true number of edges.
      num_nodes: number of nodes.
      csr, csc: :class:`Layout` of the real edges.
      strategy: ``"sparse"`` (CSR SpMM), ``"windowed"`` (``windows``) or
        ``"dense"`` (``[N, N]`` products).
      pre_normalized: the per-forward weight normalization has already been
        applied (the Trainer hoists it to init, as graphax does).
      windows: the windowed layout of a ``"windowed"`` graph, else None.
    """

    row: torch.Tensor
    col: torch.Tensor
    edge_weight: torch.Tensor
    num_edges: int
    num_nodes: int
    csr: Layout
    csc: Layout
    strategy: str = "sparse"
    pre_normalized: bool = False
    windows: object = None

    @property
    def edge_buffer_size(self) -> int:
        return int(self.row.shape[0])

    @property
    def device(self) -> torch.device:
        return self.row.device

    @property
    def edge_mask(self) -> torch.Tensor:
        """``[E_pad]`` bool: True for real edges."""
        return torch.arange(self.edge_buffer_size,
                            device=self.device) < self.num_edges

    def with_weights(self, edge_weight: torch.Tensor) -> "Graph":
        return dataclasses.replace(self, edge_weight=edge_weight)

    def to(self, device) -> "Graph":
        mv = lambda lay: Layout(*(None if t is None else t.to(device)
                                  for t in lay))
        return dataclasses.replace(
            self, row=self.row.to(device), col=self.col.to(device),
            edge_weight=self.edge_weight.to(device), csr=mv(self.csr),
            csc=mv(self.csc),
            windows=None if self.windows is None else self.windows.to(device))

    @staticmethod
    def from_edges(row, col, num_nodes: int, edge_weight=None,
                   edge_buffer_size: int | None = None,
                   device="cpu") -> "Graph":
        """Padded Graph from host edge arrays sorted by (row, col)."""
        row = np.asarray(row, dtype=np.int64)
        col = np.asarray(col, dtype=np.int64)
        e = int(row.shape[0])
        w = (np.ones((e,), np.float32) if edge_weight is None
             else np.asarray(edge_weight, dtype=np.float32))
        cap = e if edge_buffer_size is None else int(edge_buffer_size)
        if cap < e:
            raise ValueError(f"edge buffer {cap} < num edges {e}")
        csr, csc = build_layouts(row, col, num_nodes, device)
        pad = cap - e
        row_p = np.concatenate([row, np.zeros(pad, np.int64)])
        col_p = np.concatenate([col, np.zeros(pad, np.int64)])
        w_p = np.concatenate([w, np.zeros(pad, np.float32)])
        as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
        return Graph(row=as_t(row_p, torch.int64), col=as_t(col_p, torch.int64),
                     edge_weight=as_t(w_p, torch.float32), num_edges=e,
                     num_nodes=int(num_nodes), csr=csr, csc=csc)
