"""ODE blocks: per-forward graph normalisation, optional attention pin and
edge subsampling, then the solve over [0, T]."""

from graphax_torch.blocks.common import (
    BlockOutput, integrate, make_fstate, normalize_graph,
)
from graphax_torch.blocks.constant import ConstantBlock
from graphax_torch.blocks.hard_attention import HardAttentionBlock


def get_block(cfg, in_dim: int):
    """Factory keyed on cfg.block (graphax `get_block`)."""
    makers = {"constant": ConstantBlock, "hard_attention": HardAttentionBlock}
    if cfg.block not in makers:
        raise NotImplementedError(
            f"block {cfg.block!r} is not ported yet (ROADMAP Queue 1, M6/M8)")
    return makers[cfg.block](cfg, in_dim)


__all__ = ["BlockOutput", "ConstantBlock", "HardAttentionBlock", "get_block",
           "integrate", "make_fstate", "normalize_graph"]
