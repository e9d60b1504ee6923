"""Rewire-attention block: learned in-block rewiring (port of
`graphax/blocks/rewire_attention.py`, the twin of `RewireAttODEblock`,
`src/block_transformer_rewiring.py`).

Train path (`:199-216`): the head-mean attention as a transition matrix,
densified ``[N, N]`` (``new_edges="k_hop_att"``: ``S = A/2 + A^2/2`` off the
diagonal; ``"random"``: ``n (1 / (1 - rw_addD) - 1)`` uniform edges of weight
1e-6 where A has none), its top ``E_buf`` entries as the new edge set, those
above the ``1 - att_samp_pct`` quantile kept and renormalised over rows (or
columns), and the solve on the rewired graph. Eval path (`:218-223`): the
graph itself with the attention. The attention is the hard block's
(:class:`EdgeAttentionBlock`) by graphax's per-edge path, its
``attention_weights``' head mean (`:99`), not the pin.

The top entries are graphax's ``jax.lax.top_k`` of the flattened matrix:
a stable descending sort, so among equal values the lower index comes
first. The rewired graph's CSR/CSC layouts are built as the kNN rewire
builds them (`graphax_torch.rewiring.knn.rewire_graph_with_edges`: the
edges sorted by (row, col), the edge buffer kept; a dense graph stays
dense). graphax's block draws its random edges from ``PRNGKey(0)`` at every
forward (its model passes no key); the port from a generator seeded with 0
at every forward, or from ``random_edges`` (``[2, m]`` indices) where the
caller sets it, as a test does to give graphax's draw. Meant for the small
graphs graphax meant it for: the matrix is ``[N, N]``."""

from __future__ import annotations

from typing import Optional

import torch

from graphax_torch.blocks.common import (
    BlockOutput, integrate, make_fstate, normalize_graph,
)
from graphax_torch.blocks.hard_attention import EdgeAttentionBlock
from graphax_torch.rewiring.knn import rewire_graph_with_edges
from graphax_torch.sparse.ops import EPS, segment_sum
from graphax_torch.sparse.quantile import masked_quantile


def top_edges(dense: torch.Tensor, capacity: int):
    """The ``capacity`` largest entries of ``dense [N, N]`` as (row, col,
    value, count of values > 0), ties to the lower flat index
    (``jax.lax.top_k``'s order); entries of value <= 0 give row = col = 0
    and value 0."""
    n = dense.shape[0]
    vals, idx = torch.sort(dense.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:capacity], idx[:capacity]
    keep = vals > 0
    zero = torch.zeros_like(idx)
    return (torch.where(keep, idx // n, zero), torch.where(keep, idx % n, zero),
            torch.where(keep, vals, torch.zeros_like(vals)), int(keep.sum()))


class RewireAttentionBlock(EdgeAttentionBlock):
    def __init__(self, cfg, in_dim: int):
        super().__init__(cfg, in_dim)
        self.random_edges: Optional[torch.Tensor] = None

    def densify(self, graph, mean_att) -> torch.Tensor:
        """The densified weighted adjacency (`densify_edges`, `:152-160`)."""
        cfg, n = self.cfg, graph.num_nodes
        v = torch.where(graph.edge_mask, mean_att, torch.zeros_like(mean_att))
        a = torch.zeros((n, n), dtype=v.dtype, device=v.device) \
            .index_put_((graph.row, graph.col), v, accumulate=True)
        if cfg.new_edges == "k_hop_att":
            s_hat = 0.5 * a + 0.5 * (a @ a)
            return s_hat * (1.0 - torch.eye(n, dtype=a.dtype, device=a.device))
        m = max(int(n * (1.0 / (1.0 - cfg.rw_addD) - 1.0)), 1)
        r = self.random_edges
        if r is None:
            r = torch.randint(0, n, (2, m),
                              generator=torch.Generator().manual_seed(0))
        r = r.to(a.device).long()
        small = torch.where(a[r[0], r[1]] > 0, torch.zeros((), dtype=a.dtype),
                            torch.full((), 1e-6, dtype=a.dtype))
        return a.index_put_((r[0], r[1]), small, accumulate=True)

    def _renormalise(self, row, col, w, mask, num_nodes):
        index = row if self.cfg.attention_norm_idx == 0 else col
        kept = torch.where(mask, w, torch.zeros_like(w))
        sums = segment_sum(kept, index, num_nodes)[index]
        return torch.where(mask, kept / (sums + EPS), torch.zeros_like(w))

    def rewire(self, graph, mean_att):
        """(rewired graph, its per-edge values): the top entries of the
        densified matrix above the quantile, renormalised."""
        cfg, n = self.cfg, graph.num_nodes
        cap = graph.edge_buffer_size
        row, col, w, num = top_edges(self.densify(graph, mean_att), cap)
        mask = torch.arange(cap, device=w.device) < num
        thresh = masked_quantile(w, mask, 1.0 - cfg.att_samp_pct)
        keep = (w > thresh) & mask
        # the kept entries are the largest: a prefix of the top entries
        num = int(keep.sum())
        vals = self._renormalise(row, col, w, keep, n)[:num]
        row, col, w = row[:num], col[:num], w[:num]
        order = torch.argsort(row * n + col)
        g2 = rewire_graph_with_edges(graph, row[order].cpu().numpy(),
                                     col[order].cpu().numpy())
        pad = g2.edge_buffer_size - num
        grow = lambda t: torch.nn.functional.pad(t[order], (0, pad))
        return g2.with_weights(grow(w)), grow(vals)

    def forward(self, graph, x, *, train: bool, t1=None, observer=None,
                max_steps=None) -> BlockOutput:
        cfg = self.cfg
        g = normalize_graph(cfg, graph)
        with torch.no_grad():
            att = self.mean_attention(g, x, pin=False)
            if train:
                g_run, edge_vals = self.rewire(g, att)
            else:
                g_run = g
                edge_vals = torch.where(g.edge_mask, att,
                                        torch.zeros_like(att))
        fstate = make_fstate(g_run, x, attention=edge_vals, train=train,
                             cfg=cfg)
        return integrate(cfg, self.func, fstate, x, train=train, t1=t1,
                         observer=observer, max_steps=max_steps)
