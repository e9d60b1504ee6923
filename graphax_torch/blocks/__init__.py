"""ODE blocks: per-forward graph normalisation, optional attention pin and
edge subsampling, then the solve over [0, T]."""

from graphax_torch.blocks.attention import AttentionBlock
from graphax_torch.blocks.common import (
    BlockOutput, integrate, make_fstate, normalize_graph,
)
from graphax_torch.blocks.constant import ConstantBlock
from graphax_torch.blocks.hard_attention import HardAttentionBlock
from graphax_torch.blocks.mixed import MixedBlock

_MAKERS = {"constant": ConstantBlock, "attention": AttentionBlock,
           "mixed": MixedBlock, "hard_attention": HardAttentionBlock}
_UNPORTED = {"rewire_attention": "ROADMAP Queue 1, item 9 (M8)"}


def make_higher_order_block(cfg, in_dim: int):
    """graphax's `make_higher_order_block` (`graphax/blocks/higher_order.py`),
    which no config selects: not ported yet."""
    raise NotImplementedError("the higher-order block is not ported yet "
                              "(ROADMAP Queue 1, item 9 (M8))")


def get_block(cfg, in_dim: int):
    """Factory keyed on cfg.block (graphax `get_block`)."""
    if cfg.block in _UNPORTED:
        raise NotImplementedError(f"block {cfg.block!r} is not ported yet "
                                  f"({_UNPORTED[cfg.block]})")
    if cfg.block not in _MAKERS:
        raise ValueError(f"unknown block {cfg.block!r}")
    return _MAKERS[cfg.block](cfg, in_dim)


__all__ = ["AttentionBlock", "BlockOutput", "ConstantBlock",
           "HardAttentionBlock", "MixedBlock", "get_block", "integrate",
           "make_fstate", "make_higher_order_block", "normalize_graph"]
