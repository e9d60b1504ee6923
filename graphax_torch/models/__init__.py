"""Node-classification models."""

from graphax_torch.models.gnn import GNN
from graphax_torch.models.layers import BatchNorm, dropout

__all__ = ["GNN", "BatchNorm", "dropout"]
