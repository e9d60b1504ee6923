"""Node-classification models."""

from graphax_torch.models.cgnn import CGNN, make_cgnn, normalize_for_cgnn
from graphax_torch.models.early import (
    EarlyStopResult, evaluate_early_stop, make_accuracy_observer,
    masked_accuracy,
)
from graphax_torch.models.gnn import GNN
from graphax_torch.models.layers import BatchNorm, dropout
from graphax_torch.models.multimodal import MultimodalGNN

__all__ = ["CGNN", "GNN", "BatchNorm", "EarlyStopResult", "MultimodalGNN",
           "dropout",
           "evaluate_early_stop", "make_accuracy_observer", "make_cgnn",
           "masked_accuracy", "normalize_for_cgnn"]
