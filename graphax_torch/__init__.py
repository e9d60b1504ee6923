"""graphax_torch — the PyTorch/CUDA port of graphax (graph neural diffusion).

A second package beside `graphax/`, which stays the reference. Each module
here has exactly one reference module under the same subpackage name. The
port imports torch and numpy only, never jax or graphax. Entry points run on
the card unless the caller passes ``device="cpu"``.

    from graphax_torch import Trainer, best_config, get_dataset
    cfg = best_config("ogbn-arxiv")
    Trainer(cfg, get_dataset(cfg)).fit(epochs=3)
"""

from graphax_torch.data import GraphData, get_dataset, make_sbm_dataset
from graphax_torch.sparse import Graph, build_graph
from graphax_torch.train import Config, Trainer, best_config

__all__ = ["Config", "Graph", "GraphData", "Trainer", "best_config",
           "build_graph", "get_dataset", "make_sbm_dataset"]
