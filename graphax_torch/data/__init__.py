"""Datasets: container, the real-format loaders, LCC, splits, synthetic SBM
stand-ins."""

from graphax_torch.data.container import GraphData
from graphax_torch.data.lcc import largest_connected_component
from graphax_torch.data.loaders import (
    SHAPES, DatasetNotAvailable, get_dataset, load_npz_dataset,
    load_ogbn_arxiv, load_planetoid,
)
from graphax_torch.data.splits import set_train_val_test_split
from graphax_torch.data.synthetic import make_sbm_dataset

__all__ = ["DatasetNotAvailable", "GraphData", "SHAPES", "get_dataset",
           "largest_connected_component", "load_npz_dataset",
           "load_ogbn_arxiv", "load_planetoid", "make_sbm_dataset",
           "set_train_val_test_split"]
