"""Graph rewiring and positional encodings (port of `graphax/rewiring`):
kNN and edge-sampling rewiring at the epoch boundary, Beltrami's DeepWalk
and GDC encodings, the GDC and two-hop rewirings, distance utilities."""

from graphax_torch.rewiring.beltrami import (
    apply_beltrami, apply_gdc_rewiring, apply_two_hop_rewiring,
    dirichlet_energy, make_symmetric,
)
from graphax_torch.rewiring.deepwalk import (
    deepwalk_embeddings, pick_best_embeddings,
)
from graphax_torch.rewiring.distances import (
    apply_pos_dist_rewire, knn_from_distances, poincare_distances,
    quantile_threshold_adjacency,
)
from graphax_torch.rewiring.knn import (
    apply_knn, knn_graph, rewire_graph_with_edges,
)
from graphax_torch.rewiring.sampling import (
    add_edges, add_outgoing_attention_edges, apply_edge_sampling,
    edge_sampling,
)

__all__ = [
    "add_edges", "add_outgoing_attention_edges", "apply_beltrami",
    "apply_edge_sampling", "apply_gdc_rewiring", "apply_knn",
    "apply_pos_dist_rewire", "apply_two_hop_rewiring", "deepwalk_embeddings",
    "dirichlet_energy", "edge_sampling", "knn_from_distances", "knn_graph",
    "make_symmetric", "pick_best_embeddings", "poincare_distances",
    "quantile_threshold_adjacency",
    "rewire_graph_with_edges",
]
