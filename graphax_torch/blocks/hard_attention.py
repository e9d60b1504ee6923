"""Hard-attention block: train-time edge subsampling by attention quantile
(port of `graphax/blocks/hard_attention.py`, the twin of `HardAttODEblock`,
`src/block_transformer_hard_attention.py`).

Train path: the head-mean attention per edge is pinned once per forward
(the `attention_pin` kernel where it covers the config, else the plain
per-edge path), under ``use_flux`` times each edge's feature flux
``||x_row - x_col||`` (`graphax/blocks/hard_attention.py:95-97`); edges
above the ``1 - att_samp_pct`` quantile are kept and renormalised over rows,
or columns under ``attention_norm_idx=1`` (+1e-16); the solve runs on that
operator. The whole selection runs under no_grad, as in the reference. Eval
path: all edges with the head-mean attention. Dropped edges keep their slot
with value 0, as in graphax.

The attention is the block's own layer (``att_layer``) over a laplacian
RHS, and the function's own over a transformer or GAT RHS (graphax
:47-81): the pin of the transformer's ``att``, GAT's head-mean attention.
Those RHS recompute attention from the graph at every evaluation
(`graphax/functions/transformer.py:270-310`), so the pinned values reach
the solve only where the transformer's windowed route reweights with the
dense blocks built from them (graphax's ``fstate.wb[0]``), as in graphax."""

from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function

from graphax_torch.blocks.common import (
    BlockOutput, integrate, make_fstate, normalize_graph,
)
from graphax_torch.functions import get_function
from graphax_torch.functions.gat import gat_attention_apply
from graphax_torch.functions.transformer import (
    TransformerAttention, attention_edge_means,
)
from graphax_torch.sparse.ops import EPS
from graphax_torch.sparse.quantile import refined_masked_quantile


class EdgeAttentionBlock(nn.Module):
    """The attention of the blocks that select edges by it (hard, rewire):
    the block's own layer (``att_layer``) over a laplacian RHS, the
    function's own over a transformer or GAT RHS."""

    def __init__(self, cfg, in_dim: int):
        super().__init__()
        if not 0 < cfg.att_samp_pct <= 1:
            raise ValueError("attention sampling threshold must be in (0,1]")
        self.cfg = cfg
        self.func = get_function(cfg, in_dim)
        if cfg.function not in ("GAT", "transformer"):
            self.att_layer = TransformerAttention(cfg, in_dim)

    def reset_parameters(self, generator) -> None:
        self.func.reset_parameters(generator)
        if hasattr(self, "att_layer"):
            self.att_layer.reset_parameters(generator)

    def mean_attention(self, graph, x, *, pin: bool = True) -> torch.Tensor:
        """The head-mean attention per edge, ``[E_pad]``: GAT's attention
        averaged over its heads, else the transformer's or the block
        layer's, by the pin (the `attention_pin` kernel where it covers
        the config) or, without ``pin``, graphax's per-edge path."""
        if self.cfg.function == "GAT":
            return gat_attention_apply(self.func.att, self.cfg, graph,
                                       x)[0].mean(1)
        layer = self.func.att if self.cfg.function == "transformer" \
            else self.att_layer
        return attention_edge_means(layer, self.cfg, graph, x,
                                    differentiable=not pin)


class HardAttentionBlock(EdgeAttentionBlock):

    def _renormalise(self, graph, att, keep):
        """Kept attention over its sum by the norm index, the row or the
        column (+1e-16); the sum accumulates in f32 and is cast to the
        values' dtype."""
        index = graph.row if self.cfg.attention_norm_idx == 0 else graph.col
        kept = torch.where(keep, att, torch.zeros_like(att))
        sums = torch.zeros(graph.num_nodes, dtype=torch.float32,
                           device=att.device).index_add_(0, index, kept.float())
        sums = sums.to(att.dtype)[index]
        return torch.where(keep, kept / (sums + EPS), torch.zeros_like(att))

    def forward(self, graph, x, *, train: bool, t1=None, observer=None,
                max_steps=None) -> BlockOutput:
        cfg = self.cfg
        g = normalize_graph(cfg, graph)
        mask = g.edge_mask
        with torch.no_grad(), record_function("graphax_torch.pin"):
            mean_att = self.mean_attention(g, x)
            if train:
                if cfg.use_flux:
                    mean_att = mean_att * torch.linalg.vector_norm(
                        x[g.row] - x[g.col], dim=-1)
                thresh = refined_masked_quantile(mean_att, mask,
                                                 1.0 - cfg.att_samp_pct)
                keep = (mean_att > thresh) & mask
                edge_vals = self._renormalise(g, mean_att, keep)
            else:
                edge_vals = torch.where(mask, mean_att,
                                        torch.zeros_like(mean_att))
        fstate = make_fstate(g, x, attention=edge_vals, train=train,
                             cfg=cfg)
        return integrate(cfg, self.func, fstate, x, train=train, t1=t1,
                         observer=observer, max_steps=max_steps)
