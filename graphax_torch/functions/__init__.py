"""Diffusion right-hand sides f(t, x) = dx/dt."""

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
    raise NotImplementedError(
        f"function {cfg.function!r} is not ported yet (ROADMAP Queue 1, M8)")


__all__ = [
    "FuncState", "LaplacianFunction", "TransformerAttention",
    "TransformerFunction", "apply_alpha_beta", "attention_edge_means",
    "attention_means_supported", "get_function", "init_alpha_beta",
    "laplacian_rhs", "multiply_attention", "prepare_scalars",
    "transformer_attention_apply",
]
