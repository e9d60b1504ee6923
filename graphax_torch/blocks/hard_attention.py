"""Hard-attention block: train-time edge subsampling by attention quantile
(port of `graphax/blocks/hard_attention.py`, the twin of `HardAttODEblock`,
`src/block_transformer_hard_attention.py`).

Train path: the head-mean attention per edge is pinned once per forward
(the `attention_pin` kernel where it covers the config, else the plain
per-edge path); edges above the ``1 - att_samp_pct`` quantile are kept and
renormalised over rows, or columns under ``attention_norm_idx=1`` (+1e-16);
the solve runs on that operator.
The whole selection runs under no_grad, as in the reference. Eval path: all
edges with the head-mean attention. Dropped edges keep their slot with value
0, as in graphax."""

from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function

from graphax_torch.blocks.common import (
    BlockOutput, integrate, make_fstate, normalize_graph,
)
from graphax_torch.functions import get_function
from graphax_torch.functions.transformer import (
    TransformerAttention, attention_edge_means,
)
from graphax_torch.sparse.ops import EPS
from graphax_torch.sparse.quantile import refined_masked_quantile


class HardAttentionBlock(nn.Module):
    def __init__(self, cfg, in_dim: int):
        super().__init__()
        if not 0 < cfg.att_samp_pct <= 1:
            raise ValueError("attention sampling threshold must be in (0,1]")
        if cfg.use_flux:
            raise NotImplementedError("use_flux is not ported yet "
                                      "(ROADMAP Queue 1, item 6, M6)")
        if cfg.function != "laplacian":
            raise NotImplementedError("the hard block with a transformer/GAT "
                                      "function is not ported yet (ROADMAP "
                                      "Queue 1, item 6, M6)")
        self.cfg = cfg
        self.func = get_function(cfg, in_dim)
        self.att_layer = TransformerAttention(cfg, in_dim)

    def reset_parameters(self, generator) -> None:
        self.func.reset_parameters(generator)
        self.att_layer.reset_parameters(generator)

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
            mean_att = attention_edge_means(self.att_layer, cfg, g, x,
                                            differentiable=False)
            if train:
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
