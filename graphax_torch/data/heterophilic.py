"""Heterophilic benchmark datasets: Actor, WebKB (cornell/texas/wisconsin),
WikipediaNetwork (chameleon/squirrel) (port of
`graphax/data/heterophilic.py`, numpy only, so both packages parse the
same files to the same arrays).

Parsers for the geom-gcn raw layout: ``out1_node_feature_label.txt``
(node_id<TAB>feature,list<TAB>label, after a header line) and
``out1_graph_edges.txt`` (src<TAB>dst, after a header line), plus the 10
fixed split masks (``{name}_split_0.6_0.2_{i}.npz`` with
train/val/test masks) used under ``geom_gcn_splits``."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

HETEROPHILIC = ("cornell", "texas", "wisconsin", "chameleon", "squirrel",
                "film", "Actor")

HET_SHAPES = {
    "cornell": dict(num_nodes=183, num_classes=5, num_features=1703),
    "texas": dict(num_nodes=183, num_classes=5, num_features=1703),
    "wisconsin": dict(num_nodes=251, num_classes=5, num_features=1703),
    "chameleon": dict(num_nodes=2277, num_classes=5, num_features=2325),
    "squirrel": dict(num_nodes=5201, num_classes=5, num_features=2089),
    "film": dict(num_nodes=7600, num_classes=5, num_features=931),
}
HET_SHAPES["Actor"] = HET_SHAPES["film"]


def _find_raw(name: str, data_dir: str) -> Optional[str]:
    lname = "film" if name == "Actor" else name
    for cand in (os.path.join(data_dir, lname, "raw"),
                 os.path.join(data_dir, lname),
                 os.path.join(data_dir, name, "raw"), data_dir):
        if os.path.exists(os.path.join(cand,
                                       "out1_node_feature_label.txt")):
            return cand
    return None


def load_heterophilic(name: str, data_dir: str):
    """Parse the geom-gcn raw files. Returns (row, col, x, y, num_classes)
    or raises DatasetNotAvailable. Actor's features are lists of the
    indices of its nonzero (one) entries; the others' are dense."""
    from graphax_torch.data.loaders import DatasetNotAvailable

    raw = _find_raw(name, data_dir)
    if raw is None:
        raise DatasetNotAvailable(
            f"geom-gcn raw files for {name!r} not found under {data_dir} "
            "(need out1_node_feature_label.txt + out1_graph_edges.txt)")

    is_actor = name in ("film", "Actor")
    feats, labels = {}, {}
    with open(os.path.join(raw, "out1_node_feature_label.txt")) as f:
        next(f)  # header
        for line in f:
            nid, feat, label = line.strip().split("\t")
            nid = int(nid)
            if is_actor:
                feats[nid] = [int(v) for v in feat.split(",")]
            else:
                feats[nid] = [float(v) for v in feat.split(",")]
            labels[nid] = int(label)

    n = max(feats) + 1
    if is_actor:
        dim = max(max(v) for v in feats.values()) + 1
    else:
        dim = len(next(iter(feats.values())))
    x = np.zeros((n, dim), np.float32)
    for nid, vals in feats.items():
        if is_actor:
            x[nid, vals] = 1.0
        else:
            x[nid] = vals
    y = np.zeros(n, np.int64)
    for nid, lab in labels.items():
        y[nid] = lab

    rows, cols = [], []
    with open(os.path.join(raw, "out1_graph_edges.txt")) as f:
        next(f)
        for line in f:
            a, b = line.strip().split("\t")
            rows.append(int(a))
            cols.append(int(b))
    return (np.asarray(rows, np.int64), np.asarray(cols, np.int64), x, y,
            int(y.max()) + 1)


def get_fixed_splits(name: str, data_dir: str, split_idx: int,
                     num_nodes: int
                     ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The ``split_idx``-th geom-gcn fixed split (``geom_gcn_splits``) as
    (train, val, test) bool masks, or None when its file is absent."""
    lname = "film" if name == "Actor" else name
    fname = f"{lname}_split_0.6_0.2_{split_idx}.npz"
    for cand in (os.path.join(data_dir, lname, "raw", fname),
                 os.path.join(data_dir, lname, fname),
                 os.path.join(data_dir, "splits", fname),
                 os.path.join(data_dir, fname)):
        if os.path.exists(cand):
            with np.load(cand) as f:
                return (f["train_mask"].astype(bool),
                        f["val_mask"].astype(bool),
                        f["test_mask"].astype(bool))
    return None
