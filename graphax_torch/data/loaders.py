"""Dataset loaders: NumPy parsers for the standard on-disk formats, and the
`get_dataset` entry point (port of `graphax/data/loaders.py`, numpy and
scipy only, so both packages parse the same files to the same arrays).

Each parser reads the raw files a dataset ships in, if they are under
``data_dir``, and otherwise raises `DatasetNotAvailable`, which names what
to place where: Planetoid's ``ind.*`` pickles (Cora, Citeseer, Pubmed),
the shchur npz files (Computers, Photo, CoauthorCS), OGB's csv.gz layout
(ogbn-arxiv, cached to one npz that graphax reads too) and the geom-gcn
text files of the heterophilic sets. `get_dataset(...,
synthetic_fallback=True)` substitutes graphax's shape-matched SBM stand-in
when the files are absent. Then the largest connected component, the
graph and the split, as graphax's `_finish` makes them."""

from __future__ import annotations

import os
import pickle
import sys
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from graphax_torch.data.container import GraphData
from graphax_torch.data.heterophilic import (
    HET_SHAPES, HETEROPHILIC, get_fixed_splits, load_heterophilic,
)
from graphax_torch.data.lcc import largest_connected_component
from graphax_torch.data.splits import (
    planetoid_split_masks, set_train_val_test_split,
)
from graphax_torch.data.synthetic import make_sbm_dataset
from graphax_torch.sparse.build import build_graph
from graphax_torch.utils.device import resolve_device

PLANETOID = ("Cora", "Citeseer", "Pubmed")
AMAZON = ("Computers", "Photo")
COAUTHOR = ("CoauthorCS",)

# shape statistics of the synthetic stand-ins (post-LCC where relevant)
SHAPES = {
    "Cora": dict(num_nodes=2485, num_classes=7, num_features=1433),
    "Citeseer": dict(num_nodes=2120, num_classes=6, num_features=3703),
    "Pubmed": dict(num_nodes=19717, num_classes=3, num_features=500),
    "Computers": dict(num_nodes=13381, num_classes=10, num_features=767),
    "Photo": dict(num_nodes=7487, num_classes=8, num_features=745),
    "CoauthorCS": dict(num_nodes=18333, num_classes=15, num_features=6805),
    "ogbn-arxiv": dict(num_nodes=169343, num_classes=40, num_features=128),
    **HET_SHAPES,
}
NPZ_FILES = {"Computers": "amazon_electronics_computers.npz",
             "Photo": "amazon_electronics_photo.npz",
             "CoauthorCS": "ms_academic_cs.npz"}


class DatasetNotAvailable(FileNotFoundError):
    pass


def _finish(name, row, col, x, y, num_classes, *, use_lcc, self_loop_weight,
            split_seed, planetoid_split, fixed_masks=None, device=None):
    if use_lcc:
        keep, row, col = largest_connected_component(row, col, x.shape[0])
        x, y = x[keep], y[keep]
        if fixed_masks is not None:
            fixed_masks = tuple(m[keep] for m in fixed_masks)
    graph = build_graph(row, col, x.shape[0], make_undirected=True,
                        self_loop_weight=self_loop_weight, device=device)
    if fixed_masks is not None:
        tr, va, te = fixed_masks
    elif planetoid_split:
        tr, va, te = planetoid_split_masks(x.shape[0], num_classes, y)
    else:
        nd = 5000 if name == "CoauthorCS" else 1500
        nd = min(nd, max(x.shape[0] - 10, 1))
        npc = 20
        while npc > 1:
            try:
                tr, va, te = set_train_val_test_split(
                    split_seed, y, num_development=nd, num_per_class=npc)
                break
            except ValueError:
                npc //= 2
        else:
            tr, va, te = set_train_val_test_split(
                split_seed, y, num_development=nd, num_per_class=1)
    dev = graph.device
    as_t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    return GraphData(graph=graph, x=as_t(x, torch.float32),
                     y=as_t(y, torch.int64), train_mask=as_t(tr, torch.bool),
                     val_mask=as_t(va, torch.bool),
                     test_mask=as_t(te, torch.bool),
                     num_classes=int(num_classes))


# ----------------------------------------------------------------------
# Planetoid raw format (ind.<name>.{x,tx,allx,y,ty,ally,graph,test.index})
# ----------------------------------------------------------------------

def _parse_index_file(path):
    with open(path) as f:
        return np.array([int(line.strip()) for line in f], dtype=np.int64)


def load_planetoid(name: str, data_dir: str):
    """Parser for the Kipf/Planetoid pickle format (what PyG's Planetoid
    downloads into ``<root>/<name>/raw``). Returns (row, col, x, y,
    num_classes)."""
    lname = name.lower()
    raw = None
    for cand in (os.path.join(data_dir, name, "raw"),
                 os.path.join(data_dir, name), data_dir):
        if os.path.exists(os.path.join(cand, f"ind.{lname}.x")):
            raw = cand
            break
    if raw is None:
        raise DatasetNotAvailable(
            f"Planetoid raw files ind.{lname}.* not found under {data_dir}; "
            f"place the standard 8 files in {data_dir}/{name}/raw/")

    objs = {}
    for ext in ("x", "tx", "allx", "y", "ty", "ally", "graph"):
        with open(os.path.join(raw, f"ind.{lname}.{ext}"), "rb") as f:
            objs[ext] = pickle.load(f, encoding="latin1")
    test_idx = _parse_index_file(os.path.join(raw, f"ind.{lname}.test.index"))

    allx, tx = objs["allx"], objs["tx"]
    ty = objs["ty"]
    test_sorted = np.sort(test_idx)
    if name == "Citeseer":
        # isolated test nodes: extend tx/ty over the full contiguous range
        full = np.arange(test_sorted.min(), test_sorted.max() + 1)
        tx_ext = sp.lil_matrix((len(full), tx.shape[1]))
        tx_ext[test_sorted - test_sorted.min()] = tx
        tx = tx_ext.tocsr()
        ty_ext = np.zeros((len(full), ty.shape[1]))
        ty_ext[test_sorted - test_sorted.min()] = ty
        ty = ty_ext

    x = np.asarray(sp.vstack([allx, tx]).todense())
    y_onehot = np.vstack([objs["ally"], ty])
    # test rows are stored in sorted order but belong at file-order positions
    x[test_idx] = x[test_sorted]
    y_onehot[test_idx] = y_onehot[test_sorted]
    y = y_onehot.argmax(axis=1)

    rows, cols = [], []
    for src, nbrs in objs["graph"].items():
        for dst in nbrs:
            rows.append(src)
            cols.append(dst)
    return (np.asarray(rows, np.int64), np.asarray(cols, np.int64),
            x.astype(np.float32), y.astype(np.int64), y_onehot.shape[1])


# ----------------------------------------------------------------------
# Amazon / Coauthor npz format (the shchur/gnn-benchmark files PyG uses)
# ----------------------------------------------------------------------

def load_npz_dataset(name: str, data_dir: str):
    """Parser for the shchur npz layout (``adj_*`` and ``attr_*`` CSR parts,
    ``labels``). Returns (row, col, x, y, num_classes)."""
    fname = NPZ_FILES[name]
    path = None
    for cand in (os.path.join(data_dir, name, "raw", fname),
                 os.path.join(data_dir, name, fname),
                 os.path.join(data_dir, fname)):
        if os.path.exists(cand):
            path = cand
            break
    if path is None:
        raise DatasetNotAvailable(f"{fname} not found under {data_dir}")
    with np.load(path, allow_pickle=True) as f:
        adj = sp.csr_matrix((f["adj_data"], f["adj_indices"],
                             f["adj_indptr"]), shape=f["adj_shape"]).tocoo()
        x = sp.csr_matrix((f["attr_data"], f["attr_indices"],
                           f["attr_indptr"]), shape=f["attr_shape"]).toarray()
        y = f["labels"].astype(np.int64)
    return (adj.row.astype(np.int64), adj.col.astype(np.int64),
            x.astype(np.float32), y, int(y.max()) + 1)


# ----------------------------------------------------------------------
# ogbn-arxiv (the OGB raw csv.gz layout)
# ----------------------------------------------------------------------

ARXIV_CACHE = "processed_graphax.npz"


def load_ogbn_arxiv(data_dir: str):
    """Parse the OGB raw csv.gz layout. Returns (row, col, x, y, 40,
    (train, valid, test) masks). The first parse writes the arrays to
    ``processed_graphax.npz`` beside ``raw/``, with graphax's keys, and
    later calls (of either package) read that instead: the 1.2M-row edge
    file and the 169k x 128 feature csv take minutes with a text parser,
    the npz well under a second."""
    base = None
    for cand in (os.path.join(data_dir, "ogbn_arxiv"),
                 os.path.join(data_dir, "ogbn-arxiv")):
        if os.path.exists(os.path.join(cand, "raw", "edge.csv.gz")) \
                or os.path.exists(os.path.join(cand, ARXIV_CACHE)):
            base = cand
            break
    if base is None:
        raise DatasetNotAvailable(
            f"ogbn-arxiv raw files not found under {data_dir} "
            "(need <dir>/ogbn_arxiv/raw/{edge,node-feat,node-label}.csv.gz "
            "and split/time/{train,valid,test}.csv.gz)")

    cache = os.path.join(base, ARXIV_CACHE)
    if os.path.exists(cache):
        with np.load(cache) as f:
            return (f["row"], f["col"], f["x"], f["y"], 40,
                    (f["train_mask"], f["valid_mask"], f["test_mask"]))

    def read_csv_gz(p, dtype):
        try:  # pandas' C tokenizer is ~20x np.loadtxt on these files
            import pandas as pd
            return pd.read_csv(p, header=None, dtype=dtype).to_numpy()
        except ImportError:
            import gzip
            with gzip.open(p, "rt") as f:
                return np.loadtxt(f, delimiter=",", ndmin=2).astype(dtype)

    raw = os.path.join(base, "raw")
    edges = read_csv_gz(os.path.join(raw, "edge.csv.gz"), np.int64)
    x = read_csv_gz(os.path.join(raw, "node-feat.csv.gz"), np.float32)
    y = read_csv_gz(os.path.join(raw, "node-label.csv.gz"), np.int64).ravel()
    split_dir = os.path.join(base, "split", "time")
    masks = []
    for part in ("train", "valid", "test"):
        idx = read_csv_gz(os.path.join(split_dir, f"{part}.csv.gz"),
                          np.int64).ravel()
        m = np.zeros(x.shape[0], dtype=bool)
        m[idx] = True
        masks.append(m)
    try:
        np.savez_compressed(
            cache, row=edges[:, 0], col=edges[:, 1], x=x, y=y,
            train_mask=masks[0], valid_mask=masks[1], test_mask=masks[2])
    except OSError:
        pass  # read-only data dir: parse each time
    return edges[:, 0], edges[:, 1], x, y, 40, tuple(masks)


# ----------------------------------------------------------------------
# Entry point
# ----------------------------------------------------------------------

def get_dataset(cfg_or_name, data_dir: str = "./data",
                use_lcc: Optional[bool] = None,
                synthetic_fallback: bool = True,
                split_seed: int = 12345,
                geom_gcn_split_idx: int = 0, device=None) -> GraphData:
    """graphax's `get_dataset` (the reference's
    `src/graph_datasets/data.py:34-110` and the random split re-drawn from
    ``split_seed``), on ``device`` (the card unless the caller asks for
    the CPU). Accepts a Config or a dataset name.

    ``use_lcc`` defaults to ``cfg.not_lcc`` (the reference's flag: True
    keeps the largest connected component), by name to ``name !=
    "ogbn-arxiv"``; ogbn-arxiv never takes it. Where the raw files are
    absent, ``synthetic_fallback`` gives the shape-matched SBM stand-in,
    else `DatasetNotAvailable` is raised."""
    if hasattr(cfg_or_name, "dataset"):
        cfg = cfg_or_name
        name = cfg.dataset
        self_loop = cfg.self_loop_weight
        planetoid_split = cfg.planetoid_split
        geom_gcn_splits = cfg.geom_gcn_splits
        if use_lcc is None:
            use_lcc = cfg.not_lcc
    else:
        name = str(cfg_or_name)
        self_loop = 1.0
        planetoid_split = False
        geom_gcn_splits = False
        if use_lcc is None:
            use_lcc = name != "ogbn-arxiv"
    dev = resolve_device(device)

    try:
        fixed_masks = None
        if name in PLANETOID:
            row, col, x, y, nc = load_planetoid(name, data_dir)
        elif name in AMAZON + COAUTHOR:
            row, col, x, y, nc = load_npz_dataset(name, data_dir)
        elif name == "ogbn-arxiv":
            row, col, x, y, nc, fixed_masks = load_ogbn_arxiv(data_dir)
            use_lcc = False
        elif name in HETEROPHILIC:
            row, col, x, y, nc = load_heterophilic(name, data_dir)
            if geom_gcn_splits:
                fm = get_fixed_splits(name, data_dir, geom_gcn_split_idx,
                                      x.shape[0])
                if fm is not None:
                    fixed_masks = fm
        else:
            raise DatasetNotAvailable(f"unknown dataset {name!r}")
        return _finish(name, row, col, x, y, nc, use_lcc=use_lcc,
                       self_loop_weight=self_loop, split_seed=split_seed,
                       planetoid_split=planetoid_split,
                       fixed_masks=fixed_masks, device=dev)
    except DatasetNotAvailable:
        if not synthetic_fallback:
            raise
    shape = SHAPES.get(name, dict(num_nodes=1000, num_classes=5,
                                  num_features=64))
    print(f"[graphax_torch.data] {name} raw files not found — using a "
          f"shape-matched synthetic SBM stand-in (N={shape['num_nodes']})",
          file=sys.stderr)
    n, c = shape["num_nodes"], shape["num_classes"]
    # class-count-invariant homophily (~75%): expected within-class degree 3
    # and cross-class degree 1 per node regardless of C
    p_in = min(3.0 * c / n, 0.5)
    p_out = 1.0 * c / (n * max(c - 1, 1))
    noise = max(1.0, float(np.sqrt(shape["num_features"])) / 2.1)
    return make_sbm_dataset(
        num_nodes=n, num_classes=c, num_features=shape["num_features"],
        p_in=p_in, p_out=p_out, feature_noise=noise,
        seed=split_seed % (2 ** 31), self_loop_weight=self_loop,
        num_development=5000 if name == "CoauthorCS" else 1500,
        device=dev)
