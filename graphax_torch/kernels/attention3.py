"""GRAND-nl's column-normalised attention RHS over CSR through the
three-kernel form, and the autograd Function that backs the kernel routes
whose backward graphax replays from a differentiable function.

Column normalisation (``attention_norm_idx=1``, the Cora, Citeseer and
CoauthorCS tuned configs) is graphax's `_make_fused` forward with ``norm1``
(`graphax/kernels/pallas_attention.py:1078-1108`): flash cannot finish a
column's sum while it streams rows, so it keeps K1, K2 and K3:

1. q, the f32 K table and the global max of the scores over every edge and
   head, the one shift of softmax and squareplus alike (`attention_gmax`);
2. ``e = exp(s - g)`` or squareplus, unrounded (`attention_norm`);
3. the column denominators: the sum of e over each column's edges, graphax's
   XLA reduce over its transpose layout (`:1089-1101`), here a segment sum
   over the CSC layout in plain PyTorch on either device (graphax has no
   Pallas kernel there);
4. K3 per edge against its column's denominators, read at ``col[e]``
   (`attention_attspmm` with ``per_column``), its f32 sum rounded once to
   the state dtype by the kernel.

Beltrami's ``beltrami_exp`` score takes steps 1 and 2 through the two
kernels' instances of their own (the K table 2A wide), as graphax's K1
scores it on this route (its gate, `pallas_fwd_supported` `:828-838`,
does not exclude it); K3 and the column sums take e whatever the score.

Its backward is graphax's: the custom VJP replays the plain per-edge
attention (`:1135-1146`; `pallas_bwd_supported` excludes Beltrami there
too); :class:`ReplayAttention` carries that for this route and for the
windowed one (`graphax_torch.kernels.winatt`)."""

from __future__ import annotations

import torch

from graphax_torch.kernels import fused_attention as fa
from graphax_torch.kernels.fused_attention import ATT_TYPES
from graphax_torch.sparse.graph import Layout


def colnorm_supported(cfg, d: int) -> bool:
    """The column route's gate: column normalisation, the four
    `_score_math` types and Beltrami's ``beltrami_exp``, head-mean
    aggregation, and the K projection's and the score kernels' staged rows
    within one block's shared memory, at the K table's width
    (:func:`fused_attention.score_width`)."""
    a = fa.score_width(cfg)
    return (cfg.attention_norm_idx != 0 and cfg.attention_type in ATT_TYPES
            and not cfg.mix_features and not cfg.multi_modal
            and cfg.attention_dim % cfg.heads == 0
            and fa.kproj_fits(d, a) and 4 * fa._WPB * a <= fa._SMEM_STATIC)


def column_denominators(csc: Layout, e: torch.Tensor) -> torch.Tensor:
    """``[N, H]`` f32: the sum of ``e`` (``[E, H]`` in CSR slot order, that
    is edge order) over each column's edges, each column summed in turn
    over its CSC slots.

    Not an ``index_add_``: on the card that is an f32 atomic add, which
    flushes subnormal terms and sums to zero. Under one global shift a
    column far below the shift has only subnormal weights, and a flushed
    sum turns its quotients ``e / den`` into K3's zero-select, where the
    CPU (and graphax's reduce) gives the column's softmax."""
    return torch.segment_reduce(e[csc.perm], "sum", offsets=csc.ptr.long(),
                                axis=0)


def colnorm_attention_ax_fast(cfg, att, graph,
                              x: torch.Tensor) -> torch.Tensor:
    """``A(x) x`` with A the head mean of the column-normalised attention,
    through the kernels (the module's steps), in x's dtype: graphax's
    `fused_attention_ax_pallas` forward with ``attention_norm_idx=1``."""
    x = x.contiguous()
    p = fa.prep_inputs(cfg, att, graph, x)
    scal, bel = fa.score_args(p)
    kt = fa.attention_kproj(x, p["wk"], p["bk"])
    g = fa.attention_gmax(graph.csr, p["q"], kt, p["edge_w"], *scal, **bel)
    e, _ = fa.attention_norm(graph.csr, p["q"], kt, p["edge_w"], g, *scal,
                             square_plus=bool(cfg.square_plus), **bel)
    den = column_denominators(graph.csc, e)
    return fa.attention_attspmm(graph.csr, e, den, x, per_column=True,
                                out_dtype=x.dtype)


class ReplayAttention(torch.autograd.Function):
    """An attention product whose forward runs ``fast(*tensors)`` (kernels,
    nothing kept but the inputs) and whose backward is the vjp of
    ``plain(*tensors)``, a differentiable function of the same value,
    replayed under autograd: graphax's custom VJPs that replay an XLA
    function (`pallas_winatt.py:249-267`, `pallas_attention.py:1135-1146`).
    The cotangent is cast to the output's dtype first, as graphax's."""

    @staticmethod
    def forward(ctx, fast, plain, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return fast(*tensors)

    @staticmethod
    def backward(ctx, g):
        ts = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(nd) for t, nd in zip(ts, needs)]
            out = ctx.plain(*ins)
            wanted = [t for t, nd in zip(ins, needs) if nd]
            got = iter(torch.autograd.grad(out, wanted, g.to(out.dtype),
                                           allow_unused=True))
        grads = []
        for t, nd in zip(ts, needs):
            v = next(got) if nd else None
            grads.append(torch.zeros_like(t) if nd and v is None else v)
        return (None, None, *grads)
