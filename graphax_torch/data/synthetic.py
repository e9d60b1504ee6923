"""Synthetic stochastic-block-model datasets (port of
`graphax/data/synthetic.py`): the communities are the labels and the
features are noisy class prototypes. The graph and the split come from the
same numpy RandomState draws as graphax's, so both packages build the same
dataset from the same seed."""

from __future__ import annotations

import numpy as np
import torch

from graphax_torch.data.container import GraphData
from graphax_torch.data.splits import set_train_val_test_split
from graphax_torch.sparse.build import build_graph
from graphax_torch.utils.device import resolve_device


def sbm_arrays(rng: np.random.RandomState, num_nodes: int, num_classes: int,
               num_features: int, p_in: float, p_out: float,
               feature_noise: float):
    """The SBM's labels, edges and features as numpy arrays (row, col, x,
    y), drawn from ``rng`` in graphax's order."""
    y = rng.randint(0, num_classes, num_nodes)

    # undirected SBM edges sampled block-wise without an N^2 matrix
    rows, cols = [], []
    for ci in range(num_classes):
        for cj in range(ci, num_classes):
            p = p_in if ci == cj else p_out
            ni = np.where(y == ci)[0]
            nj = np.where(y == cj)[0]
            m = rng.binomial(len(ni) * len(nj), p)
            if m == 0:
                continue
            r = ni[rng.randint(0, len(ni), m)]
            c = nj[rng.randint(0, len(nj), m)]
            keep = r != c
            rows.append(r[keep]); cols.append(c[keep])
    row = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    col = np.concatenate(cols) if cols else np.zeros(0, np.int64)

    prototypes = rng.randn(num_classes, num_features)
    x = prototypes[y] + feature_noise * rng.randn(num_nodes, num_features)
    x = x / np.sqrt(1.0 + feature_noise ** 2)
    return row, col, x, y


def make_sbm_dataset(num_nodes: int = 400, num_classes: int = 4,
                     num_features: int = 32, p_in: float = 0.04,
                     p_out: float = 0.002, feature_noise: float = 1.0,
                     seed: int = 0, self_loop_weight: float = 1.0,
                     num_development: int = None, num_per_class: int = 20,
                     pad_multiple: int = 128, strategy: str = "auto",
                     device=None) -> GraphData:
    dev = resolve_device(device)
    row, col, x, y = sbm_arrays(np.random.RandomState(seed), num_nodes,
                                num_classes, num_features, p_in, p_out,
                                feature_noise)

    graph = build_graph(row, col, num_nodes, make_undirected=True,
                        self_loop_weight=self_loop_weight,
                        pad_multiple=pad_multiple, strategy=strategy,
                        device=dev)
    if num_development is None:
        num_development = max(min(num_nodes // 2, 1500),
                              num_per_class * num_classes + 10)
    num_development = min(num_development, max(num_nodes - 10, 1))
    npc = min(num_per_class, num_nodes)
    while npc > 1:
        try:
            tr, va, te = set_train_val_test_split(
                12345, y, num_development=num_development, num_per_class=npc)
            break
        except ValueError:
            npc //= 2
    else:
        tr, va, te = set_train_val_test_split(
            12345, y, num_development=num_development, num_per_class=1)
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
    return GraphData(graph=graph, x=as_t(x, torch.float32),
                     y=as_t(y, torch.int64), train_mask=as_t(tr, torch.bool),
                     val_mask=as_t(va, torch.bool),
                     test_mask=as_t(te, torch.bool), num_classes=num_classes)
