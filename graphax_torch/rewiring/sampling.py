"""Edge addition and removal between epochs (port of
`graphax/rewiring/sampling.py`).

The scores come from the block's attention layer on the model's device
(the plain per-edge path, graphax's route here on every backend); the
topology is assembled on the host in numpy, with randomness from a numpy
``RandomState`` as in graphax. Removal keeps the edges on the kept side of
a quantile of their scores: where a score lies within f32 rounding of the
threshold, the port and graphax may keep different edges."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from graphax_torch.blocks.common import normalize_graph
from graphax_torch.rewiring.knn import rewire_graph_with_edges
from graphax_torch.sparse import build


def _attention_layer(model):
    block = model.block
    att = getattr(block, "att_layer", None)
    if att is None:
        att = getattr(getattr(block, "func", None), "att", None)
    if att is None:
        raise ValueError("edge sampling reads the block's attention layer: "
                         "use an attention block or the transformer "
                         "function")
    return att


@torch.no_grad()
def block_attention(model, cfg, graph, z, attention_type=None):
    """(head-mean attention ``[E_pad]``, head-mean raw scores ``[E_pad]``,
    the normalised graph) from the block's attention layer on ``z``, as
    numpy; ``attention_type`` overrides the score type
    (`graphax/rewiring/sampling.py:23-39`)."""
    from graphax_torch.functions.transformer import edge_attention

    g = normalize_graph(cfg, graph)
    cfg_use = cfg if attention_type is None else \
        cfg.replace(attention_type=attention_type)
    att, prods = edge_attention(_attention_layer(model), cfg_use, g, z)
    return (att.mean(1).float().cpu().numpy(),
            prods.mean(1).float().cpu().numpy(), g)


def _edges(graph):
    mask = graph.edge_mask.cpu().numpy()
    return graph.row.cpu().numpy(), graph.col.cpu().numpy(), mask


def edge_sampling(model, cfg, graph, z) -> Tuple[np.ndarray, np.ndarray]:
    """Remove edges by attention quantile (keep the high ones) or by
    distance quantile (keep the close pairs). Returns (row, col)."""
    row, col, mask_real = _edges(graph)
    space = cfg.edge_sampling_space
    if space == "attention":
        mean_att, _, _ = block_attention(model, cfg, graph, z)
        vals = mean_att[mask_real]
        threshold = np.quantile(vals, cfg.edge_sampling_rmv)
        keep = vals >= threshold
    elif space in ("pos_distance", "z_distance", "pos_distance_QK",
                   "z_distance_QK"):
        if space.endswith("_QK"):
            _, prods, _ = block_attention(model, cfg, graph, z,
                                          attention_type="exp_kernel")
            dist = -np.log(np.maximum(prods, 1e-30))
        else:
            zz = z.float().cpu().numpy()
            dist = np.sum((zz[row] - zz[col]) ** 2, axis=-1)
        vals = dist[mask_real]
        threshold = np.quantile(vals, 1 - cfg.edge_sampling_rmv)
        keep = vals < threshold
    else:
        raise ValueError(f"unknown edge_sampling_space {space!r}")
    r, c = row[mask_real][keep], col[mask_real][keep]
    if cfg.edge_sampling_sym:
        r, c = build.to_undirected(r, c, graph.num_nodes)
    return r, c


def add_outgoing_attention_edges(rng, graph, mean_att, m: int
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """M anchor nodes drawn in proportion to the softmax of their
    degree-normalised incoming attention, each joined to a uniform partner
    in both directions."""
    n = graph.num_nodes
    _, col, mask = _edges(graph)
    att = np.asarray(mean_att)
    importance = np.zeros(n)
    np.add.at(importance, col[mask], att[mask])
    degree = np.zeros(n)
    np.add.at(degree, col[mask], 1.0)
    normed = np.divide(importance, np.maximum(degree, 1.0))
    probs = np.exp(normed - normed.max())
    probs = probs / probs.sum()
    anchors = rng.choice(n, size=m, replace=True, p=probs)
    partners = rng.choice(n, size=m, replace=True)
    return (np.concatenate([anchors, partners]),
            np.concatenate([partners, anchors]))


def add_edges(rng, graph, cfg, mean_att=None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """``edge_sampling_add * E`` new edges (random, importance, or the full
    adjacency), deduplicated with the existing ones."""
    n = graph.num_nodes
    row, col, mask = _edges(graph)
    row, col = row[mask], col[mask]
    m = int(len(row) * cfg.edge_sampling_add)
    kind = cfg.edge_sampling_add_type
    if kind == "n2_radius":
        return build.full_adjacency(n)
    if m <= 0:
        return row, col
    if kind == "random":
        new = rng.randint(0, n, size=(2, m))
        row_new = np.concatenate([new[0], new[1]])
        col_new = np.concatenate([new[1], new[0]])
    elif kind == "importance":
        if mean_att is None:
            raise ValueError("importance addition needs attention")
        row_new, col_new = add_outgoing_attention_edges(rng, graph,
                                                        mean_att, m)
    else:
        raise ValueError(f"unsupported edge_sampling_add_type {kind!r}")
    r, c, _ = build.coalesce(np.concatenate([row, row_new]),
                             np.concatenate([col, col_new]), None, n)
    return r, c


@torch.no_grad()
def apply_edge_sampling(cfg, model, data, rng=None):
    """`apply_edge_sampling` (`graphax/rewiring/sampling.py:128-156`): add
    edges, embed (T0 or TN on the densified graph), remove by score, and
    return the new Graph (its weights not normalised yet)."""
    rng = rng or np.random.RandomState(0)
    model.eval()
    z0 = model.encode(data.x, train=False, pos_encoding=data.pos_encoding)
    mean_att = None
    if cfg.edge_sampling_add_type == "importance":
        mean_att, _, _ = block_attention(model, cfg, data.graph, z0)
    r, c = add_edges(rng, data.graph, cfg, mean_att)
    g_dense = rewire_graph_with_edges(data.graph, r, c,
                                      self_loop_weight=cfg.self_loop_weight,
                                      keep_capacity=False)
    if cfg.edge_sampling_T == "T0":
        z = z0
    else:
        z = model.forward_ode(g_dense, data.x, train=False,
                              pos_encoding=data.pos_encoding)[0]
    r2, c2 = edge_sampling(model, cfg, g_dense, z)
    return rewire_graph_with_edges(data.graph, r2, c2,
                                   self_loop_weight=cfg.self_loop_weight,
                                   keep_capacity=False)
