"""Attaching the windowed layout to a graph (port of `attach_windows`,
`graphax/kernels/dispatch.py:65-87`).

graphax also routes between its XLA segment ops and TPU row tiles here; the
port's CSR and CSC layouts are always present, so only the windowed layout
is attached. The dense strategy's routing stays in ROADMAP Queue 1, M7."""

from __future__ import annotations

import dataclasses

from graphax_torch.kernels.windows import build_window_tiles


def attach_windows(graph, window: int = 512, tile: int = 128):
    """A copy of ``graph`` carrying the windowed layout, with
    ``strategy="windowed"``. Host-side; node ids should be community-ordered
    first (`graphax_torch.data.reorder.community_reorder` does both)."""
    e = graph.num_edges
    wl = build_window_tiles(graph.row[:e].cpu().numpy(),
                            graph.col[:e].cpu().numpy(), graph.num_nodes,
                            tile=tile, window=window, device=graph.device)
    return dataclasses.replace(graph, windows=wl, strategy="windowed")
