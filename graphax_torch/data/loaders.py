"""Dataset entry point (port of `graphax/data/loaders.py:36-44, 236-305`).

`get_dataset` uses graphax's shape-matched synthetic SBM stand-ins. The
parsers of the real on-disk formats are not ported yet (ROADMAP Queue 1,
M4): where a dataset's raw files are present, `get_dataset` raises rather
than quietly train on the stand-in."""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np

from graphax_torch.data.container import GraphData
from graphax_torch.data.synthetic import make_sbm_dataset

# shape statistics of the synthetic stand-ins (post-LCC where relevant)
SHAPES = {
    "Cora": dict(num_nodes=2485, num_classes=7, num_features=1433),
    "Citeseer": dict(num_nodes=2120, num_classes=6, num_features=3703),
    "Pubmed": dict(num_nodes=19717, num_classes=3, num_features=500),
    "Computers": dict(num_nodes=13381, num_classes=10, num_features=767),
    "Photo": dict(num_nodes=7487, num_classes=8, num_features=745),
    "CoauthorCS": dict(num_nodes=18333, num_classes=15, num_features=6805),
    "ogbn-arxiv": dict(num_nodes=169343, num_classes=40, num_features=128),
}
_NPZ = {"Computers": "amazon_electronics_computers.npz",
        "Photo": "amazon_electronics_photo.npz",
        "CoauthorCS": "ms_academic_cs.npz"}


def _raw_files(name: str, data_dir: str) -> Optional[str]:
    """Where graphax's parsers would find the real files, or None."""
    if name in ("Cora", "Citeseer", "Pubmed"):
        f = f"ind.{name.lower()}.x"
        cands = [os.path.join(data_dir, name, "raw", f),
                 os.path.join(data_dir, name, f), os.path.join(data_dir, f)]
    elif name in _NPZ:
        f = _NPZ[name]
        cands = [os.path.join(data_dir, name, "raw", f),
                 os.path.join(data_dir, name, f), os.path.join(data_dir, f)]
    elif name == "ogbn-arxiv":
        cands = [os.path.join(data_dir, d, sub)
                 for d in ("ogbn_arxiv", "ogbn-arxiv")
                 for sub in (os.path.join("raw", "edge.csv.gz"),
                             "processed_graphax.npz")]
    else:
        raise NotImplementedError(f"dataset {name!r} is not ported yet "
                                  "(ROADMAP Queue 1, M4/M9)")
    return next((c for c in cands if os.path.exists(c)), None)


def get_dataset(cfg_or_name, data_dir: str = "./data",
                split_seed: int = 12345, device=None) -> GraphData:
    """The synthetic stand-in of a dataset, built as graphax's
    `get_dataset(..., synthetic_fallback=True)` builds it when the raw files
    are absent. Accepts a Config or a dataset name."""
    if hasattr(cfg_or_name, "dataset"):
        name = cfg_or_name.dataset
        self_loop = cfg_or_name.self_loop_weight
    else:
        name = str(cfg_or_name)
        self_loop = 1.0
    found = _raw_files(name, data_dir)
    if found is not None:
        raise NotImplementedError(
            f"{found} exists, but the real-format parsers are not ported yet "
            "(ROADMAP Queue 1, M4); move the files away to use the synthetic "
            "stand-in")
    shape = SHAPES[name]
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
        device=device)
