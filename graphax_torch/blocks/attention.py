"""Attention block ("linear" GRAND): the head-mean transformer attention
pinned once per forward from x(0) as the diffusion operator (port of
`graphax/blocks/attention.py`, the twin of `AttODEblock`,
`src/block_transformer_attention.py`).

The block owns its attention layer (``att_layer``), apart from any
attention inside the RHS. The pin drives the laplacian RHS only; the
transformer RHS recomputes attention at every evaluation and ignores it, so
there it is skipped, as in graphax. In training the pin is the plain
per-edge path with autograd: the gradient reaches ``att_layer`` through the
pinned operator (the dense strategy's ``[N, N]`` operator, the CSR values,
or the windowed blocks and residual), by the adjoint or by autograd through
the accepted steps. In evaluation it takes the `attention_pin` kernel where
the kernel covers the config (`functions.transformer.attention_edge_means`)."""

from __future__ import annotations

from torch import nn
from torch.profiler import record_function

from graphax_torch.blocks.common import (
    BlockOutput, integrate, make_fstate, normalize_graph,
)
from graphax_torch.functions import get_function
from graphax_torch.functions.transformer import (
    TransformerAttention, attention_edge_means, transformer_attention_apply,
)


class AttentionBlock(nn.Module):
    def __init__(self, cfg, in_dim: int):
        super().__init__()
        self.cfg = cfg
        self.func = get_function(cfg, in_dim)
        self.att_layer = TransformerAttention(cfg, in_dim)

    def reset_parameters(self, generator) -> None:
        self.func.reset_parameters(generator)
        self.att_layer.reset_parameters(generator)

    def attention_weights(self, graph, x):
        """Per-edge per-head attention ``[E_pad, H]`` of the block's layer
        (graphax's ``forward.attention_weights``)."""
        return transformer_attention_apply(self.att_layer, self.cfg, graph,
                                           x)[0]

    def pinned_values(self, graph, x, differentiable: bool, y=None):
        """The operator's per-edge values pinned from x(0): the head-mean
        attention (`attention_edge_means`), of x's cross-attention over
        the second modality ``y`` under multi_modal."""
        return attention_edge_means(self.att_layer, self.cfg, graph, x,
                                    differentiable=differentiable, y=y)

    def forward(self, graph, x, *, train: bool, y=None, t1=None,
                observer=None, max_steps=None, samples=1) -> BlockOutput:
        cfg = self.cfg
        g = normalize_graph(cfg, graph)
        values = None
        if cfg.function == "laplacian":
            with record_function("graphax_torch.pin"):
                values = self.pinned_values(g, x, differentiable=train, y=y)
        fstate = make_fstate(g, x, attention=values, train=train, cfg=cfg,
                             y=y)
        return integrate(cfg, self.func, fstate, x, train=train, t1=t1,
                         observer=observer, max_steps=max_steps,
                         samples=samples)
