"""GNN_KNN: the rewiring experiments' model with the "fully adjacent" last
layer (port of `graphax/models/gnn_knn.py`, `src/GNN_KNN.py`).

The encoder -> ODE -> decoder of :class:`GNN`, plus, under ``fa_layer``, a
second block that runs after the main solve on a caller-supplied densified
graph with a fixed rk4 step over [0, 1] (`src/GNN_KNN.py:66-84`). Without
``fa_layer`` it holds exactly the plain model's parameters, so checkpoints
and `load_graphax_params` carry over either way; without a ``fa_graph`` the
fa block is skipped, as graphax's Trainer never passes one."""

from __future__ import annotations

import torch

from graphax_torch.blocks import get_block
from graphax_torch.models.gnn import GNN


class GNNKNN(GNN):
    def __init__(self, cfg, num_features: int, num_classes: int):
        super().__init__(cfg, num_features, num_classes)
        if cfg.fa_layer:
            cfg_fa = cfg.replace(method="rk4", time=1.0, step_size=1.0,
                                 adjoint=False)
            self.fa_block = get_block(cfg_fa, self.state_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        if self.cfg.fa_layer:
            self.fa_block.reset_parameters(generator)

    def forward_ode(self, graph, x, *, train: bool, generator=None, t1=None,
                    observer=None, max_steps=None, pos_encoding=None,
                    fa_graph=None):
        z, out = super().forward_ode(graph, x, train=train,
                                     generator=generator, t1=t1,
                                     observer=observer, max_steps=max_steps,
                                     pos_encoding=pos_encoding)
        if self.cfg.fa_layer and fa_graph is not None:
            # on the solve's output as it is, as graphax's fa block
            z = self.fa_block(fa_graph, z, train=train).z
        return z, out

    def forward(self, graph, x, *, train: bool, generator=None, t1=None,
                observer=None, max_steps=None, pos_encoding=None,
                fa_graph=None):
        z, out = self.forward_ode(graph, x, train=train, generator=generator,
                                  t1=t1, observer=observer,
                                  max_steps=max_steps,
                                  pos_encoding=pos_encoding,
                                  fa_graph=fa_graph)
        return self.decode(z, train=train, generator=generator), out
