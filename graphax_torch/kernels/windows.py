"""Host-side windowed (block-dense) edge layout.

Port of `graphax/kernels/windows.py`: `community_order` (:84-99) and the
layout rules of `build_window_tiles` (:102-209). Node rows fall into
``T = ceil(N / tile)`` tiles; each tile takes the aligned ``window``-wide
column range holding most of its edges (the argmax of
``bincount(tile * Wn + col // window)``, ties to the lowest window). An edge
is in-window iff its column lies in its tile's window; those edges become
the dense per-tile blocks ``[T, tile, window]`` once per forward
(`windowed_spmm.densify_windows`), and the rest (the residual) goes through
the CSR SpMM.

The TPU's 2,048-slot edge blocks, ``first`` flags and scalar-prefetch tables
are not carried over. The GPU layout is:

- the in-window edges as a flat list: each edge's buffer position and its
  cell ``t * tile * W + lrow * W + lcol`` in the dense blocks;
- ``tile_win [T]``, each tile's window;
- a window -> tiles CSR (``win_ptr``, ``win_tiles``) for `win_bwd_slab`;
- a CSR and a CSC :class:`Layout` of the residual edges, whose ``perm``
  holds each slot's edge position;
- built at first use and kept (GRAND-nl's windowed attention reads them):
  the occupied cells as a CSR over rows (``in_window``, the cell lists the
  windowed attention kernel walks) and as a ``[T, tile, W]`` bool mask
  (``dense_mask``, graphax's ``WindowTiles.dense_mask``).

No hub layout: graphax extracts hub columns from the residual with a cost
model in TPU v5e constants (`graphax/kernels/hubs.py:65-73`), which the port
does not carry over, and on the synthetic ogbn-arxiv graph that model picks
no hubs (ROADMAP, "the hub layout")."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from graphax_torch.kernels._build import publish
from graphax_torch.sparse.graph import Layout, _ptr, build_layouts


@dataclasses.dataclass(frozen=True)
class WindowLayout:
    tile_win: torch.Tensor    # [T] int32, the window of each row tile
    win_edge: torch.Tensor    # [Ew] int32, buffer position of each in-window edge
    win_cell: torch.Tensor    # [Ew] int32, its cell in the [T, tile, W] blocks
    win_ptr: torch.Tensor     # [Wn + 1] int32, window -> tiles CSR
    win_tiles: torch.Tensor   # [T] int32, tiles in window order
    residual: Layout          # CSR of the out-of-window edges
    residual_t: Layout        # CSC of the same edges
    tile: int
    window: int
    num_tiles: int
    num_windows: int
    num_nodes: int

    @property
    def in_window_edges(self) -> int:
        return int(self.win_edge.shape[0])

    @property
    def block_shape(self) -> tuple:
        return (self.num_tiles, self.tile, self.window)

    @functools.cached_property
    def in_window(self) -> Layout:
        """The occupied cells of the blocks as a CSR over rows, each cell
        once in (row, column) order: ``idx`` its column (int32), ``seg`` its
        row, ``perm`` the cell in the flattened ``[T, tile, W]`` blocks."""
        w = self.window
        cell = torch.unique(self.win_cell.long())          # sorted
        row = cell // w
        col = self.tile_win.long()[row // self.tile] * w + cell % w
        counts = torch.bincount(row, minlength=self.num_nodes)
        ptr = torch.zeros(self.num_nodes + 1, dtype=torch.int64,
                          device=cell.device)
        ptr[1:] = torch.cumsum(counts, 0)
        lay = Layout(ptr=ptr.to(torch.int32), seg=row,
                     idx=col.to(torch.int32), perm=cell)
        publish(lay.idx)        # every field queued: finished before shared
        return lay

    @functools.cached_property
    def dense_mask(self) -> torch.Tensor:
        """``[T, tile, W]`` bool: the cells an in-window edge occupies."""
        m = torch.zeros(self.num_tiles * self.tile * self.window,
                        dtype=torch.bool, device=self.win_cell.device)
        m[self.win_cell.long()] = True
        return publish(m.reshape(self.block_shape))

    @functools.cached_property
    def graphax_residual_slots(self) -> tuple:
        """The slots of graphax's blocked residual value tables (``res``
        and ``res_t``), padding included (:func:`tiled_slots`): graphax's
        adaptive adjoint integrates them, the padding and the transpose's
        values as zero leaves."""
        return (tiled_slots(self.residual, self.num_nodes, self.tile),
                tiled_slots(self.residual_t, self.num_nodes, self.tile))

    def to(self, device) -> "WindowLayout":
        mv = lambda t: t.to(device)
        lay = lambda l: Layout(*(mv(t) for t in l))
        return dataclasses.replace(
            self, tile_win=mv(self.tile_win), win_edge=mv(self.win_edge),
            win_cell=mv(self.win_cell), win_ptr=mv(self.win_ptr),
            win_tiles=mv(self.win_tiles), residual=lay(self.residual),
            residual_t=lay(self.residual_t))


_BLOCK_EDGES = (384, 512, 640, 768, 1024, 1280, 1536, 1792, 2048, 2560,
                3072, 4096)


def tiled_slots(layout: Layout, num_nodes: int, tile: int) -> int:
    """The slots of graphax's row-tiled table of ``layout``'s edges
    (`build_row_tiles` with its cost model's block size,
    `graphax/kernels/tiles.py:51-80`): each row tile's edges in blocks of
    ``Eb`` slots, ``Eb`` minimising ``slots + 90 * blocks``, at least one
    block."""
    t = (num_nodes + tile - 1) // tile
    deg = np.bincount((layout.seg // tile).cpu().numpy(), minlength=t)
    best_eb, best_cost, best_blocks = None, None, 0
    for eb in _BLOCK_EDGES:
        blocks = int(((deg + eb - 1) // eb).sum())
        cost = blocks * eb + 90 * blocks
        if best_cost is None or cost < best_cost:
            best_eb, best_cost, best_blocks = eb, cost, blocks
    return max(best_blocks, 1) * best_eb


def community_order(row, col, num_nodes: int, window: int = 512):
    """Node permutation grouping community labels into contiguous id runs.

    Labels come from the native greedy region-growing partitioner with
    capacity ``window``, so each community fits one aligned window. Returns
    ``perm`` with ``perm[old_id] = new_id``."""
    from graphax_torch import native

    num_parts = max((num_nodes + window - 1) // window, 1)
    labels, _ = native.partition_bfs(row, col, num_nodes, num_parts, window)
    order = np.argsort(labels, kind="stable")      # new_id -> old_id
    perm = np.empty(num_nodes, np.int64)
    perm[order] = np.arange(num_nodes)
    return perm


def build_window_tiles(row, col, num_nodes: int, tile: int = 128,
                       window: int = 512, device="cpu") -> WindowLayout:
    """The windowed layout of the real edges ``row``/``col`` (sorted by
    (row, col), as a Graph's buffer prefix holds them)."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    if window % tile:
        raise ValueError("window must be a multiple of the row tile")
    n = int(num_nodes)
    t = (n + tile - 1) // tile
    wn = (n + window - 1) // window
    if t * tile * window >= 2 ** 31:
        raise ValueError("dense blocks beyond int32 cell indices")

    tile_of_edge = row // tile
    win_of_edge = col // window
    counts = np.bincount(tile_of_edge * wn + win_of_edge,
                         minlength=t * wn).reshape(t, wn)
    best = counts.argmax(axis=1)                          # [T], ties -> lowest

    in_win = win_of_edge == best[tile_of_edge]
    idx_in = np.nonzero(in_win)[0]
    idx_res = np.nonzero(~in_win)[0]
    # t * tile * W + (r - t * tile) * W + (c - best[t] * W)
    cell = row[idx_in] * window + col[idx_in] \
        - best[tile_of_edge[idx_in]] * window

    # the residual's CSR and CSC, their slots mapped to edge positions
    res, res_t = build_layouts(row[idx_res], col[idx_res], n, device)
    ids = torch.as_tensor(idx_res, dtype=torch.int64, device=device)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    return WindowLayout(
        tile_win=as_t(best), win_edge=as_t(idx_in), win_cell=as_t(cell),
        win_ptr=as_t(_ptr(best, wn)),
        win_tiles=as_t(np.argsort(best, kind="stable")),
        residual=res._replace(perm=ids), residual_t=res_t._replace(
            perm=ids[res_t.perm]),
        tile=int(tile), window=int(window), num_tiles=t, num_windows=wn,
        num_nodes=n)
