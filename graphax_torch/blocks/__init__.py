"""ODE blocks: per-forward graph normalisation, optional attention pin,
edge subsampling or rewiring, then the solve over [0, T]."""

from graphax_torch.blocks.attention import AttentionBlock
from graphax_torch.blocks.common import (
    BlockOutput, integrate, make_fstate, normalize_graph,
)
from graphax_torch.blocks.constant import ConstantBlock
from graphax_torch.blocks.hard_attention import HardAttentionBlock
from graphax_torch.blocks.higher_order import (
    HigherOrderBlock, make_higher_order_block,
)
from graphax_torch.blocks.mixed import MixedBlock
from graphax_torch.blocks.rewire_attention import RewireAttentionBlock

_MAKERS = {"constant": ConstantBlock, "attention": AttentionBlock,
           "mixed": MixedBlock, "hard_attention": HardAttentionBlock,
           "rewire_attention": RewireAttentionBlock}


def get_block(cfg, in_dim: int):
    """Factory keyed on cfg.block (graphax `get_block`)."""
    if cfg.block not in _MAKERS:
        raise ValueError(f"unknown block {cfg.block!r}")
    return _MAKERS[cfg.block](cfg, in_dim)


__all__ = ["AttentionBlock", "BlockOutput", "ConstantBlock",
           "HardAttentionBlock", "HigherOrderBlock", "MixedBlock",
           "RewireAttentionBlock", "get_block", "integrate", "make_fstate",
           "make_higher_order_block", "normalize_graph"]
