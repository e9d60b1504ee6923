"""Host-side native code (port of `graphax/native/__init__.py:175-231`).

Only the community partitioner is ported: `partition_bfs` runs
`gx_partition_grow` (`graphbuild.cpp`, a copy of graphax's) through
``ctypes``. The library is built by ``g++`` at first use into
``graphax_torch/native/_build/`` (``kernels._build.host_library``); a failed
build raises. graphax's pure-Python fallback is not ported: it walks the
heap in the same order, but at ogbn-arxiv scale it takes minutes where the
native code takes a second."""

from __future__ import annotations

import ctypes

import numpy as np

from graphax_torch.kernels._build import host_library


def partition_bfs(row, col, num_nodes: int, num_parts: int, cap: int):
    """Balanced greedy (max-gain) region-growing labels ``[N]`` in
    ``[0, num_parts)``, bit for bit graphax's. Returns (labels, edge_cut)."""
    row = np.ascontiguousarray(row, dtype=np.int64)
    col = np.ascontiguousarray(col, dtype=np.int64)
    labels = np.empty(num_nodes, np.int64)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    cut = host_library("graphbuild").gx_partition_grow(
        ptr(row), ptr(col), len(row), num_nodes, num_parts, cap, ptr(labels))
    return labels, int(cut)
