"""Diffusion right-hand sides f(t, x) = dx/dt."""

from graphax_torch.functions.gat import GATFunction, gat_attention_apply
from graphax_torch.functions.common import (
    FuncState, apply_alpha_beta, init_alpha_beta, prepare_scalars,
)
from graphax_torch.functions.laplacian import LaplacianFunction, laplacian_rhs
from graphax_torch.functions.transformer import (
    TransformerAttention, TransformerFunction, attention_edge_means,
    attention_means_supported, multiply_attention,
    transformer_attention_apply,
)


def get_function(cfg, in_dim: int):
    """Factory keyed on cfg.function (graphax `get_function`)."""
    if cfg.function == "laplacian":
        return LaplacianFunction(cfg, in_dim)
    if cfg.function == "transformer":
        return TransformerFunction(cfg, in_dim)
    if cfg.function == "GAT":
        return GATFunction(cfg, in_dim)
    raise ValueError(f"unknown function {cfg.function!r}")


__all__ = [
    "FuncState", "GATFunction", "LaplacianFunction", "TransformerAttention",
    "TransformerFunction", "apply_alpha_beta", "attention_edge_means",
    "attention_means_supported", "gat_attention_apply", "get_function",
    "init_alpha_beta", "laplacian_rhs", "multiply_attention", "prepare_scalars",
    "transformer_attention_apply",
]
