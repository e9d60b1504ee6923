"""DIGL (GDC-paper) precomputed-diffusion datasets and seeded splits (port
of `graphax/data/digl.py`).

Twin of `src/graph_datasets/DIGL_data.py`: `PPRDataset`/`HeatDataset` wrap a
base dataset with its adjacency replaced by the exact PPR matrix
alpha (I - (1 - alpha) T)^-1 or the heat kernel expm(-t (I - T)), sparsified
by top-k or clipping (`:126-161,193-345`), plus the paper's seeded split
protocol (`DIGL_seeds.py`: fixed development seed + per-run test seeds).
The diffusion runs on the host (`graphax_torch.data.gdc`); the new graph
is built on the dataset's device with its strategy resolved as
`build_graph`'s ``"auto"``."""

from __future__ import annotations

from graphax_torch.data.container import GraphData
from graphax_torch.data.gdc import gdc_diffusion
from graphax_torch.data.splits import set_train_val_test_split
from graphax_torch.sparse.build import build_graph

# `DIGL_seeds.py` development seed; test seeds are drawn per run
DEVELOPMENT_SEED = 1684992425


def ppr_dataset(data: GraphData, alpha: float = 0.05, k: int = 64,
                eps=None) -> GraphData:
    """Replace the adjacency with the sparsified exact-PPR diffusion."""
    return _diffused(data, method="ppr", alpha=alpha, k=k, eps=eps)


def heat_dataset(data: GraphData, t: float = 3.0, k: int = 64,
                 eps=None) -> GraphData:
    """Replace the adjacency with the sparsified heat-kernel diffusion."""
    return _diffused(data, method="heat", heat_time=t, k=k, eps=eps)


def _diffused(data: GraphData, **kw) -> GraphData:
    g = data.graph
    e = g.num_edges
    row = g.row[:e].cpu().numpy()
    col = g.col[:e].cpu().numpy()
    sparsification = "topk" if kw.get("eps") is None else "threshold"
    r, c, w, _ = gdc_diffusion(row, col, g.num_nodes, method=kw.get(
        "method", "ppr"), alpha=kw.get("alpha", 0.05),
        heat_time=kw.get("heat_time", 3.0), sparsification=sparsification,
        k=kw.get("k", 64), eps=kw.get("eps"))
    return data.with_graph(build_graph(r, c, g.num_nodes, edge_weight=w,
                                       device=g.device))


def digl_split(data: GraphData, seed: int,
               num_development: int = 1500) -> GraphData:
    """The DIGL seeded split: development pool drawn with the fixed
    DEVELOPMENT_SEED-derived protocol, per-run seed for the class draw."""
    y = data.y.cpu().numpy()
    nd = min(num_development, max(len(y) - 10, 1))
    npc = 20
    while npc > 1:
        try:
            tr, va, te = set_train_val_test_split(seed, y,
                                                  num_development=nd,
                                                  num_per_class=npc)
            break
        except ValueError:
            npc //= 2
    else:
        tr, va, te = set_train_val_test_split(seed, y, num_development=nd,
                                              num_per_class=1)
    return data.with_masks(tr, va, te)
