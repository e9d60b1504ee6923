"""Dataset container: a Graph plus node features, labels and split masks
(port of `graphax/data/container.py`)."""

from __future__ import annotations

import dataclasses

import torch

from graphax_torch.sparse.graph import Graph


@dataclasses.dataclass(frozen=True)
class GraphData:
    graph: Graph
    x: torch.Tensor            # [N, F] float32
    y: torch.Tensor            # [N] int64 labels
    train_mask: torch.Tensor   # [N] bool
    val_mask: torch.Tensor
    test_mask: torch.Tensor
    num_classes: int

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes

    @property
    def num_features(self) -> int:
        return int(self.x.shape[-1])

    def to(self, device) -> "GraphData":
        return dataclasses.replace(
            self, graph=self.graph.to(device), x=self.x.to(device),
            y=self.y.to(device), train_mask=self.train_mask.to(device),
            val_mask=self.val_mask.to(device),
            test_mask=self.test_mask.to(device))
