"""Mixed block: the diffusion operator ``(1 - sigmoid(gamma)) attention +
sigmoid(gamma) adjacency`` with a learnable scalar ``gamma`` (init 0), the
attention pinned once per forward as in the attention block (port of
`graphax/blocks/mixed.py`, the twin of `MixedODEblock`,
`src/block_mixed.py`). The mix drives the laplacian RHS only. Regularised
RHS raise in `integrate`, as for every block."""

from __future__ import annotations

import torch
from torch import nn

from graphax_torch.blocks.attention import AttentionBlock


class MixedBlock(AttentionBlock):
    def __init__(self, cfg, in_dim: int):
        super().__init__(cfg, in_dim)
        self.gamma = nn.Parameter(torch.zeros(()))

    def reset_parameters(self, generator) -> None:
        super().reset_parameters(generator)
        nn.init.zeros_(self.gamma)

    def mixed_attention(self, graph, x, differentiable: bool = True):
        """Per-edge ``mean (1 - sigmoid(gamma)) + w sigmoid(gamma)`` over the
        normalised graph's weights ``w``. A bf16 pin meets gamma in f32, as
        graphax's promotion of a bf16 array against an f32 one does."""
        gamma = torch.sigmoid(self.gamma)
        mean = super().pinned_values(graph, x, differentiable)
        mean = mean.to(torch.promote_types(mean.dtype, gamma.dtype))
        return mean * (1 - gamma) + graph.edge_weight * gamma

    def pinned_values(self, graph, x, differentiable: bool):
        return self.mixed_attention(graph, x, differentiable)
