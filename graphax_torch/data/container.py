"""Dataset container: a Graph plus node features, labels and split masks
(port of `graphax/data/container.py`)."""

from __future__ import annotations

import dataclasses
from typing import Optional

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
    pos_encoding: Optional[torch.Tensor] = None   # [N, P] f32 (Beltrami)

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
            test_mask=self.test_mask.to(device),
            pos_encoding=None if self.pos_encoding is None
            else self.pos_encoding.to(device))

    def with_masks(self, train_mask, val_mask, test_mask) -> "GraphData":
        """The split masks (numpy or tensors) as bool on the features'
        device."""
        m = lambda t: torch.as_tensor(t, dtype=torch.bool,
                                      device=self.x.device)
        return dataclasses.replace(self, train_mask=m(train_mask),
                                   val_mask=m(val_mask),
                                   test_mask=m(test_mask))

    def with_graph(self, graph: Graph) -> "GraphData":
        return dataclasses.replace(self, graph=graph)

    def with_pos_encoding(self, pos_encoding) -> "GraphData":
        """``pos_encoding [N, P]`` (numpy or tensor) as f32 on the
        features' device (`graphax/data/container.py:47-48`)."""
        pe = torch.as_tensor(pos_encoding, dtype=torch.float32,
                             device=self.x.device)
        return dataclasses.replace(self, pos_encoding=pe)
