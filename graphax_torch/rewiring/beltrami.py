"""Beltrami's positional encodings and the GDC and two-hop rewirings (port
of `graphax/rewiring/beltrami.py`).

The encodings are GDC diffusion columns (NMF-compressed on graphs of more
than 5,000 nodes) or DeepWalk embeddings, cached as pickles at
``{cache_dir}/pos_encodings/{dataset}_{type}.pkl``: DeepWalk's as
``{"data", "acc"}``, GDC's as the array, graphax's layout, so a file
written by either package loads in the other. A caller applies them as
graphax's driver does (`graphax/drivers/run_gnn.py:83-88`)::

    enc = apply_beltrami(data, cfg, cache_dir=...)
    cfg = cfg.replace(pos_enc_dim=enc.shape[1])
    data = data.with_pos_encoding(enc)"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from graphax_torch.data.gdc import gdc_diffusion, gdc_pos_encoding
from graphax_torch.kernels.spmm import spmm_csr
from graphax_torch.sparse import build
from graphax_torch.sparse.ops import rw_norm_weights


def pos_encoding_path(cache_dir: str, dataset: str, enc_type: str) -> str:
    return os.path.join(cache_dir, "pos_encodings",
                        f"{dataset}_{enc_type}.pkl")


def _real_edges(graph):
    e = graph.num_edges
    return graph.row[:e].cpu().numpy(), graph.col[:e].cpu().numpy()


def apply_beltrami(data, cfg, cache_dir: str = "./data", seed: int = 0
                   ) -> np.ndarray:
    """The positional encodings ``[N, P]`` f32 of ``cfg.pos_enc_type``
    (``DW<dim>`` or ``GDC``), from the cache where it holds them, else
    computed and cached. DeepWalk's skip-gram trains on the features'
    device."""
    enc_type = cfg.pos_enc_type
    path = pos_encoding_path(cache_dir, cfg.dataset, enc_type)
    if os.path.exists(path):
        with open(path, "rb") as f:
            obj = pickle.load(f)
        enc = obj["data"] if isinstance(obj, dict) and "data" in obj else obj
        return np.asarray(enc, dtype=np.float32)

    g = data.graph
    row, col = _real_edges(g)
    if enc_type.startswith("DW"):
        from graphax_torch.rewiring.deepwalk import deepwalk_embeddings

        dim = int(enc_type[2:] or 64)
        enc, acc = deepwalk_embeddings(row, col, g.num_nodes, dim,
                                       labels=data.y.cpu().numpy(),
                                       seed=seed, device=data.x.device)
        payload = {"data": enc, "acc": acc}
    elif enc_type == "GDC":
        embedding_dim = None
        if g.num_nodes > 5000:
            embedding_dim = max(cfg.pos_enc_hidden_dim, 64)
        enc = gdc_pos_encoding(
            row, col, g.num_nodes, orientation=cfg.pos_enc_orientation,
            embedding_dim=embedding_dim, method=cfg.gdc_method,
            alpha=cfg.ppr_alpha, heat_time=cfg.heat_time,
            sparsification=cfg.gdc_sparsification, k=cfg.gdc_k,
            eps=cfg.gdc_threshold)
        payload = enc
    else:
        raise ValueError(f"unknown pos_enc_type {enc_type!r}")

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return np.asarray(enc, dtype=np.float32)


def apply_gdc_rewiring(data, cfg):
    """``data`` on the GDC-diffused, sparsified, column-normalised
    adjacency (`apply_gdc`), on the old graph's strategy."""
    g = data.graph
    row, col = _real_edges(g)
    r, c, w, _ = gdc_diffusion(
        row, col, g.num_nodes, method=cfg.gdc_method, alpha=cfg.ppr_alpha,
        heat_time=cfg.heat_time, sparsification=cfg.gdc_sparsification,
        k=cfg.gdc_k, eps=cfg.gdc_threshold if cfg.gdc_threshold else None,
        avg_degree=cfg.gdc_avg_degree)
    new_graph = build.build_graph(r, c, g.num_nodes, edge_weight=w,
                                  strategy=g.strategy, device=g.device)
    return data.with_graph(new_graph)


def apply_two_hop_rewiring(data, cfg=None):
    """``rewiring='two_hop'``: ``data`` on the edge set of A + A^2."""
    g = data.graph
    r, c = build.two_hop(*_real_edges(g), g.num_nodes)
    return data.with_graph(build.build_graph(r, c, g.num_nodes,
                                             device=g.device))


def make_symmetric(graph):
    """A + A^T (the weights twice, duplicates summed), then rw-normalised
    over columns with no self-loop fill. Returns host (row, col, w)."""
    e = graph.num_edges
    row, col = _real_edges(graph)
    w = graph.edge_weight[:e].cpu().numpy()
    r, c, ww = build.coalesce(np.concatenate([row, col]),
                              np.concatenate([col, row]),
                              np.concatenate([w, w]), graph.num_nodes)
    w_norm = rw_norm_weights(torch.as_tensor(r), torch.as_tensor(c),
                             torch.as_tensor(ww, dtype=torch.float32),
                             graph.num_nodes, norm_dim=1)
    return r, c, w_norm.numpy()


def dirichlet_energy(graph, x) -> np.ndarray:
    """``X^T A X``, the smoothness diagnostic; ``A X`` through the CSR SpMM
    (the kernel on the card)."""
    x = torch.as_tensor(x, device=graph.device).contiguous()
    vals = graph.edge_weight.to(x.dtype).contiguous()
    ax = spmm_csr(graph.csr, vals, x, graph.num_nodes)
    return (x.T @ ax).cpu().numpy()
