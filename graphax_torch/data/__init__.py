"""Datasets: container, splits, synthetic SBM stand-ins."""

from graphax_torch.data.container import GraphData
from graphax_torch.data.loaders import SHAPES, get_dataset
from graphax_torch.data.splits import set_train_val_test_split
from graphax_torch.data.synthetic import make_sbm_dataset

__all__ = ["GraphData", "SHAPES", "get_dataset", "make_sbm_dataset",
           "set_train_val_test_split"]
