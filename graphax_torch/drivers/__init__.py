"""Training CLIs and experiment harnesses, ports of `graphax/drivers/`:
`run_gnn` (node classification over repeated splits, the README's
Quickstart), `run_multi` (the multimodal family), `sweep` (ASHA/TPE
sweeps and the winner's replication), `explicit_implicit` (the solver
comparison), `run_cgnn` (the CGNN baseline) and `visualize` (figures;
matplotlib and networkx imported inside its functions)."""

from graphax_torch.drivers.run_gnn import main as run_gnn_main
from graphax_torch.drivers.run_multi import main as run_multi_main

__all__ = ["run_gnn_main", "run_multi_main"]
