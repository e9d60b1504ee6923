"""Train/val/test split protocols (port of `graphax/data/splits.py`, numpy
only, so splits agree bit for bit).

`set_train_val_test_split` reproduces the reference's seeded random protocol
exactly (`src/graph_datasets/data.py:154-181`): a development pool of 1500
nodes (5000 for CoauthorCS), 20 per class drawn from the pool for train, the
rest of the pool for val, everything outside the pool for test — including
the detail that the RandomState is re-seeded before the per-class draw."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def set_train_val_test_split(seed: int, y: np.ndarray,
                             num_development: int = 1500,
                             num_per_class: int = 20
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    y = np.asarray(y)
    num_nodes = y.shape[0]
    rnd_state = np.random.RandomState(seed)
    development_idx = rnd_state.choice(num_nodes, num_development,
                                       replace=False)
    dev_set = set(development_idx.tolist())
    test_idx = [i for i in range(num_nodes) if i not in dev_set]

    train_idx: list = []
    rnd_state = np.random.RandomState(seed)  # re-seeded, as in the reference
    for c in range(int(y.max()) + 1):
        class_idx = development_idx[np.where(y[development_idx] == c)[0]]
        # identical to the reference whenever the pool holds >= num_per_class
        # members of the class (always true on the real datasets); the clamp
        # only keeps tiny fixture/synthetic graphs from raising
        k = min(num_per_class, len(class_idx))
        if k > 0:
            train_idx.extend(rnd_state.choice(class_idx, k, replace=False))

    train_set = set(int(i) for i in train_idx)
    val_idx = [i for i in development_idx if int(i) not in train_set]

    def mask(idx):
        m = np.zeros(num_nodes, dtype=bool)
        m[np.asarray(idx, dtype=np.int64)] = True
        return m

    return mask(train_idx), mask(val_idx), mask(test_idx)


def planetoid_split_masks(num_nodes: int, num_classes: int, y: np.ndarray,
                          num_test: int = 1000, num_val: int = 500
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The standard fixed Planetoid split: 20 labeled nodes per class (the
    first 20 in node order), 500 val, 1000 test — used when
    `--planetoid_split` (`src/graph_datasets/run_GNN.py:237-238`)."""
    train = np.zeros(num_nodes, dtype=bool)
    for c in range(num_classes):
        idx = np.where(np.asarray(y) == c)[0][:20]
        train[idx] = True
    remaining = np.where(~train)[0]
    val = np.zeros(num_nodes, dtype=bool)
    val[remaining[:num_val]] = True
    test = np.zeros(num_nodes, dtype=bool)
    test[remaining[num_val:num_val + num_test]] = True
    return train, val, test
