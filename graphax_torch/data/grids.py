"""Grid and chain graph construction for the multimodal pipeline (the port's
copy of `graphax/data/grids.py`, numpy only).

Twin of `grid_edge_index_calc` / `text_edge_index_calc`
(`src/data_multi.py:113-197`): pixel images become 4- or 8-neighbor grid
graphs (directed both ways), token sequences become chain graphs. Exact
edge-count identities are asserted as in the reference."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def grid_edge_index(height: int, width: int, diagonals: bool = False
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Edges of an H×W pixel grid; 4-neighbor, or 8-neighbor when
    ``diagonals``. Returns directed edges in both directions."""
    idx = np.arange(height * width).reshape(height, width)
    rows, cols = [], []

    def connect(a, b):
        rows.append(a.ravel()); cols.append(b.ravel())
        rows.append(b.ravel()); cols.append(a.ravel())

    connect(idx[:, :-1], idx[:, 1:])        # horizontal
    connect(idx[:-1, :], idx[1:, :])        # vertical
    if diagonals:
        connect(idx[:-1, :-1], idx[1:, 1:])   # ↘
        connect(idx[:-1, 1:], idx[1:, :-1])   # ↙
    row = np.concatenate(rows).astype(np.int64)
    col = np.concatenate(cols).astype(np.int64)

    # exact count identities (`src/data_multi.py:150-189`)
    e4 = 2 * (height * (width - 1) + width * (height - 1))
    ed = 2 * 2 * (height - 1) * (width - 1)
    assert row.shape[0] == (e4 + ed if diagonals else e4), \
        (row.shape[0], e4, ed)
    return row, col


def chain_edge_index(length: int, bidirectional: bool = True
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Chain graph over a token sequence (`text_edge_index_calc`,
    `src/data_multi.py:192-197`)."""
    src = np.arange(length - 1, dtype=np.int64)
    dst = src + 1
    if bidirectional:
        return np.concatenate([src, dst]), np.concatenate([dst, src])
    return src, dst


def image_to_grid_features(images: np.ndarray, patch: int = 1
                           ) -> np.ndarray:
    """[B, H, W, C] images → [B, (H/p)·(W/p), C·p²] per-patch grid features
    (the cheap stand-in for the reference's ResNet-101 patch extractor,
    `src/data_multi.py:201-248`, which needs pretrained weights)."""
    b, h, w, c = images.shape
    assert h % patch == 0 and w % patch == 0
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c)
    x = x.transpose(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, patch * patch * c)
    return x
