"""GRAND-nl's attention RHS on the windowed layout through the kernels:
the windowed attention kernel (K5) on the in-window cells, the three-kernel
form on the residual edges.

Replaces graphax's `_make_winatt_kernel` (`graphax/kernels/pallas_winatt.
py:43`, K5) with `csrc/winatt.cu`, and the forward of `_make_winatt`
(`:156-238`) around it with :func:`windowed_attention_ax_fast`, the
counterpart of `windowed_attention_ax_pallas` (`:273`):

1. q and k projected and rounded to the state dtype (dense products, as
   graphax leaves them to XLA); for scaled_dot the residual's q is q / sqrt
   (dk) in the state dtype (`:181-184`);
2. the f32 K table of the residual's scores (`attention_kproj`: the
   gathered rows' projection from the weight in the state dtype plus the
   f32 bias, `:187-189`);
3. r0, the residual scores' max over every edge and head, 0 when there is
   none (`attention_gmax`, `:206-213`);
4. the residual ``e = exp(s - r0)`` and its row sums ``d_res``
   (`attention_norm`, `:214-217`);
5. K5 (:func:`winatt`) on the occupied cells of each row, with r0 and
   ``d_res``: the in-window aggregate and the combined denominators;
6. the residual aggregate against those denominators (`attention_attspmm`
   in its row form, `:234-236`), with K5's f32 half as its addend: the sum
   of the two f32 halves, rounded once to the state dtype by the kernel.

So the two halves of one row see different k and q in bf16, as graphax's:
K5 reads k rounded to the state dtype from the f32 weight and the
unscaled q, and divides its f32 dot product by sqrt(dk); the residual reads
k in f32 from the rounded weight and the pre-scaled rounded q. In f32 both
are the same values to rounding.

K5 walks each row's occupied cells (`WindowLayout.in_window`, each cell
once) where graphax's kernel walks each 128-row tile's dense ``[128, W]``
block: the same function (graphax's masked cells add zeros to every sum),
at 0.66 % of the dense work on ogbn-arxiv. It is the CSR row walk of the
flash kernel with K5's arithmetic: a group of ``LANES`` lanes owns a row
of at most as many cells, one cell a lane, the scores in registers,
the x rows gathered by :func:`~graphax_torch.kernels.fused_attention.
gather_width`'s loads; a row of more cells goes in segments of 32 cells to
two more kernels, a warp a segment, summed in segment order
(:func:`~graphax_torch.kernels.fused_attention.row_split_plan`, made once
per layout), as the flash kernel's long rows.

Softmax only (graphax's `pallas_winatt_ok`); the squareplus route is the
plain twin (`graphax_torch.kernels.windowed_attention`). None of these is
differentiable; the RHS wraps this route in an autograd Function whose
backward replays the twin, as graphax's custom VJP does (`:249-267`)."""

from __future__ import annotations

import numpy as np
import torch

from graphax_torch.kernels import _build
from graphax_torch.kernels import fused_attention as fa
from graphax_torch.kernels.fused_attention import ATT_TYPES, score_math
from graphax_torch.sparse.graph import Layout
from graphax_torch.sparse.ops import segment_max, segment_sum
from graphax_torch.utils.params import linear_apply

# lanes that own a row in winatt.cu (its LANES; two rows a warp; rows of
# more cells go to its segment kernels), chosen by measurement on the card
# (PERF.md)
LANES = 16


def winatt_supported(cfg, d: int) -> bool:
    """graphax's `pallas_winatt_ok` (`:290-295`) with the card in place of
    its TPU: softmax, the four `_score_math` types, not Beltrami's split
    score, within the shared memory of the K projection (K5 itself uses
    none)."""
    a = cfg.attention_dim
    return (not cfg.square_plus and not fa.beltrami_exp(cfg)
            and not cfg.mix_features and not cfg.multi_modal
            and cfg.attention_type in ATT_TYPES and a % cfg.heads == 0
            and fa.kproj_fits(d, a))


def _sqrt_dk(dk: int) -> float:
    return float(np.float32(np.sqrt(dk)))


def winatt_scores_plain(win: Layout, q, k, edge_w, att_type: str,
                        heads: int, ov2: float = 1.0, inv2l2: float = 0.5):
    """K5's scores at the occupied cells, ``[Ew, H]`` f32, from the
    unscaled q and k in the state dtype (`:60-90`): scaled_dot divides the
    f32 dot product by sqrt(dk); exp_kernel expands the squared distance;
    times the cell's weight when ``edge_w`` is given."""
    e, dk = win.num_slots, q.shape[1] // heads
    qe = q.float()[win.seg].reshape(e, heads, dk)
    ke = k.float()[win.idx.long()].reshape(e, heads, dk)
    if att_type == "scaled_dot":
        s = (qe * ke).sum(-1) / _sqrt_dk(dk)
    elif att_type == "exp_kernel":
        sq = ((qe * qe).sum(-1) + (ke * ke).sum(-1)) - 2.0 * (qe * ke).sum(-1)
        s = ov2 * torch.exp(-sq * inv2l2)
    else:
        s = score_math(att_type, qe, ke)
    if edge_w is not None:
        s = s * edge_w[:, None]
    return s


def winatt_plain(win: Layout, q, k, x, d_res, r0, edge_w, att_type: str,
                 heads: int, ov2: float = 1.0, inv2l2: float = 0.5):
    """K5's function in plain PyTorch over the occupied cells: (out [N, D]
    f32, the combined denominators [N, H] f32 in r0's frame)."""
    n, seg = win.num_rows, win.seg
    s = winatt_scores_plain(win, q, k, edge_w, att_type, heads, ov2, inv2l2)
    shift = torch.maximum(segment_max(s, seg, n), r0 - 70.0)     # [N, H]
    shift = torch.where(shift <= fa.NEG / 2, torch.zeros_like(shift), shift)
    e = torch.exp(s - shift[seg])
    d = segment_sum(e, seg, n) \
        + d_res * torch.exp(torch.clamp(r0 - shift, -70.0, 70.0))
    dsafe = torch.where(d > 0, d, torch.ones_like(d))[seg]
    pbar = torch.zeros_like(e[:, 0])
    for h in range(heads):
        pbar = pbar + e[:, h] / dsafe[:, h]
    w = (pbar * (1.0 / heads)).to(x.dtype).float()
    out = torch.zeros((n, x.shape[1]), dtype=torch.float32, device=x.device)
    out.index_add_(0, seg, x[win.idx.long()].float() * w[:, None])
    return out, d * torch.exp(torch.clamp(shift - r0, -70.0, 70.0))


def winatt(win: Layout, q: torch.Tensor, k: torch.Tensor, x: torch.Tensor,
           d_res: torch.Tensor, r0: torch.Tensor, edge_w, att_type: str,
           heads: int, ov2: float = 1.0, inv2l2: float = 0.5):
    """graphax's K5 over the occupied cells ``win`` (the layout's
    ``in_window``): ``(out, den)`` as the plain version. ``q`` (unscaled),
    ``k`` ``[N, A]`` and ``x [N, D]`` in one dtype; ``d_res [N, H]`` f32,
    the residual's row sums in r0's frame; ``r0`` a 0-d f32 tensor;
    ``edge_w`` f32 per cell or None."""
    if att_type not in ATT_TYPES:
        raise ValueError(f"winatt: unsupported att_type {att_type!r}")
    fa._no_grad("winatt", q, k, x, d_res, edge_w)
    if not x.is_cuda:
        return winatt_plain(win, q, k, x, d_res, r0, edge_w, att_type,
                            heads, ov2, inv2l2)
    n, d = x.shape
    a = q.shape[1]
    if x.dtype not in fa._DTYPES or q.dtype != x.dtype or k.dtype != x.dtype:
        raise TypeError("winatt: q, k and x must share a float32 or bfloat16 "
                        "dtype")
    if q.shape != (n, a) or k.shape != (n, a) or heads < 1 or a % heads:
        raise ValueError("winatt: q and k [N, A] with heads dividing A")
    if d_res.dtype != torch.float32 or d_res.shape != (n, heads):
        raise ValueError("winatt: d_res must be [N, H] f32")
    if r0.dtype != torch.float32 or r0.numel() != 1:
        raise ValueError("winatt: r0 must be one f32 value")
    fa._check_layout("winatt", win, n, None)
    if edge_w is not None and (edge_w.dtype != torch.float32
                               or edge_w.shape != (win.num_slots,)):
        raise ValueError("winatt: edge_w must be f32, one value per cell")
    fa._check_operands("winatt", x, win.ptr, win.idx, q, k, x, d_res, r0,
                       edge_w)
    # rows of more than LANES cells: segments of one batch each
    plan, nlong, nseg = fa._row_plan(win, LANES, fa._BATCH)
    st = torch.empty((nseg, 2 * heads), dtype=torch.float32, device=x.device)
    part = torch.empty((nseg, d), dtype=torch.float32, device=x.device)
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    den = torch.empty((n, heads), dtype=torch.float32, device=x.device)
    err = _build.library("winatt").gx_winatt(
        win.ptr.data_ptr(), win.idx.data_ptr(), q.data_ptr(), k.data_ptr(),
        x.data_ptr(), edge_w.data_ptr() if edge_w is not None else None,
        d_res.data_ptr(), r0.data_ptr(), plan.data_ptr(), st.data_ptr(),
        part.data_ptr(), out.data_ptr(), den.data_ptr(), n, d, a, heads,
        ATT_TYPES[att_type], int(edge_w is not None), float(ov2),
        float(inv2l2), fa._DTYPES[x.dtype], fa.gather_width(x),
        fa.score_vec(q, k, heads, att_type), nlong, nseg,
        _build.stream_ptr(x))
    _build.check(err, "winatt")
    _build.count_launch("winatt")
    return out, den


def windowed_attention_ax_fast(cfg, att, graph, x: torch.Tensor,
                               dense_weight=None) -> torch.Tensor:
    """``A(x) x`` on the windowed layout through the kernels (see the
    module's steps), in x's dtype; graphax's `windowed_attention_ax_pallas`
    forward. ``dense_weight``: the ``[T, tile, W]`` densified edge weights,
    read only with ``reweight_attention``."""
    wl = graph.windows
    res, win = wl.residual, wl.in_window
    heads, dt = cfg.heads, x.dtype
    x = x.contiguous()
    q = linear_apply(att.Q, x).to(dt).contiguous()
    k = linear_apply(att.K, x).to(dt).contiguous()
    q_s = q
    if cfg.attention_type == "scaled_dot":
        dk = cfg.attention_dim // heads
        q_s = (q / torch.sqrt(torch.tensor(dk, dtype=torch.float32)).to(dt)
               ).contiguous()
    kt = fa.attention_kproj(x, att.K.weight.t().to(dt).contiguous(),
                            att.K.bias.float().contiguous())
    ov2 = inv2l2 = 0.0
    if cfg.attention_type == "exp_kernel":
        ov2 = float(att.output_var ** 2)
        inv2l2 = float(1.0 / (2.0 * att.lengthscale ** 2))
    scal = (cfg.attention_type, heads, ov2, inv2l2)
    ew_res = ew_win = None
    if cfg.reweight_attention:
        ew_res = graph.edge_weight[res.perm].float().contiguous()
        ew_win = dense_weight.reshape(-1)[win.perm].float().contiguous()
    r0 = fa.attention_gmax(res, q_s, kt, ew_res, *scal)
    e_res, d_res = fa.attention_norm(res, q_s, kt, ew_res, r0, *scal)
    out_win, den = winatt(win, q, k, x, d_res, r0, ew_win, *scal)
    return fa.attention_attspmm(res, e_res, den, x, addend=out_win,
                                out_dtype=dt)
