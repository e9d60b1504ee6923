"""Attention pin: the per-edge head-mean of row-softmax transformer attention.

Replaces graphax's K1 + K2 + `attention_edge_means_pallas`
(`graphax/kernels/pallas_attention.py:114, 197, 944-991`); the CUDA source
is `csrc/attention_pin.cu`. Covered: the `_score_math` score types
scaled_dot (q pre-scaled by the caller), cosine_sim, pearson, exp_kernel
and Beltrami's beltrami_exp (q and the K weight in the layout of
`fused_attention.beltrami_columns`), with reweight on or off, row softmax
without squareplus (the gate of `attention_means_supported`, :994-997).
Not differentiable: the hard-attention block calls it under no_grad.

On the card it runs two kernels: the K table ``K = x Wk + bk [N, A]`` in
f32, once per node, through :func:`fused_attention.attention_kproj`
(graphax's K1 projects each gathered source row: the same f32 sums of
exact state-dtype products, in another order), then the pin's row walk
over the CSR, which gathers K rows (A values per edge, not D). Rows of
more than 32 edges go to segments of ``fused_attention.ROW_SPLIT`` edges
(:func:`fused_attention.row_split_plan`), whose per-head (max, sum) are
combined in segment order before the write pass. beltrami_exp takes the
kernels' instances of their own (two lanes a (edge, head) pair, one half
each): the K table by 16-byte loads of each half where
:func:`fused_attention.flash_kvec` allows (a half of a multiple of 4
values), else one value at a time, and each warp's shared row rounded up
to 4 floats (:func:`fused_attention.flash_warps` counts it).

dtype steps as graphax's kernel path: q and Wk in the state dtype, bk and
every score in f32; the output is f32 (the caller casts it to the state
dtype)."""

from __future__ import annotations

import torch

from graphax_torch.kernels import _build
from graphax_torch.kernels import fused_attention as fa
from graphax_torch.sparse.graph import Layout
from graphax_torch.sparse.ops import segment_max, segment_sum


def attention_pin_plain(layout: Layout, q, x, wk, bk, edge_w, att_type: str,
                        heads: int, ov2: float = 1.0, inv2l2: float = 0.5, *,
                        ov2p: float = 1.0, inv2l2p: float = 0.5):
    """The pin in plain PyTorch: ``[layout.num_slots]`` f32."""
    e, n = layout.num_slots, layout.num_rows
    seg, col = layout.seg, layout.idx.long()
    k_nodes = x.float() @ wk.float() + bk.float()         # [N, A] f32
    qe = q.float()[seg].reshape(e, heads, -1)
    ke = k_nodes[col].reshape(e, heads, -1)
    s = fa.score_math(att_type, qe, ke, ov2, inv2l2, ov2p=ov2p,
                      inv2l2p=inv2l2p)                     # [E, H]
    if edge_w is not None:
        s = s * edge_w[:e, None].float()
    shift = segment_max(s, seg, n)
    ex = torch.exp(s - shift[seg])
    den = segment_sum(ex, seg, n)
    den = torch.where(den > 0, den, torch.ones_like(den))
    return (ex / den[seg]).mean(1)


def attention_pin(layout: Layout, q: torch.Tensor, x: torch.Tensor,
                  wk: torch.Tensor, bk: torch.Tensor, edge_w, att_type: str,
                  heads: int, ov2: float = 1.0, inv2l2: float = 0.5, *,
                  ov2p: float = 1.0, inv2l2p: float = 0.5) -> torch.Tensor:
    """Head-mean attention per CSR slot, ``[layout.num_slots]`` f32.

    ``q [N, A]`` (pre-scaled for scaled_dot) and ``x [N, D]``, ``wk [D, A]``
    in one dtype; ``bk [A]`` f32; ``edge_w [>= E]`` f32 reweight values or
    None; ``ov2p`` and ``inv2l2p``: beltrami_exp's positional pair."""
    if att_type not in fa.ATT_TYPES:
        raise ValueError(f"attention_pin: unsupported att_type {att_type!r}")
    if att_type == "beltrami_exp" and (q.shape[1] // heads) % 2:
        raise ValueError("attention_pin: beltrami_exp needs an even head "
                         "slice")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, x, wk, bk, edge_w)):
        raise RuntimeError("attention_pin is not differentiable; call it "
                           "under torch.no_grad()")
    if not x.is_cuda:
        return attention_pin_plain(layout, q, x, wk, bk, edge_w, att_type,
                                   heads, ov2, inv2l2, ov2p=ov2p,
                                   inv2l2p=inv2l2p)
    n, d = x.shape
    a = q.shape[1]
    if x.dtype not in fa._DTYPES or q.dtype != x.dtype \
            or wk.dtype != x.dtype:
        raise TypeError("attention_pin: q, x and wk must share a float32 or "
                        "bfloat16 dtype")
    if q.shape[0] != n or wk.shape != (d, a) or bk.shape != (a,) \
            or bk.dtype != torch.float32:
        raise ValueError("attention_pin: shapes q [N, A], x [N, D], wk [D, A], "
                         "bk [A] f32 required")
    if heads < 1 or heads > 32 or a % heads:
        raise ValueError("attention_pin: heads must divide A and be <= 32")
    if layout.num_rows != n:
        raise ValueError("attention_pin: layout and x disagree on N")
    wpb = fa.flash_warps(a, heads, att_type)
    if not fa.kproj_supported(x.dtype, d, a) or wpb < 1:
        raise ValueError(f"attention_pin: A too large for shared memory "
                         f"(D={d}, A={a}, H={heads})")
    tensors = [layout.ptr, layout.idx, q, x, wk, bk]
    if edge_w is not None:
        if edge_w.dtype != torch.float32 or edge_w.shape[0] < layout.num_slots:
            raise ValueError("attention_pin: edge_w must be f32 with one value "
                             "per slot")
        tensors.append(edge_w)
    for t in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("attention_pin: operands must be contiguous and "
                             f"on {x.device}")
    kt = fa.attention_kproj(x, wk, bk)
    plan, nlong, nseg = fa._row_plan(layout, fa._BATCH, fa.ROW_SPLIT)
    st = torch.empty((nseg, 2 * heads), dtype=torch.float32, device=x.device)
    out = torch.empty(layout.num_slots, dtype=torch.float32, device=x.device)
    kvec = fa.flash_kvec(kt, heads, att_type)
    lib = _build.library("attention_pin")
    err = lib.gx_attention_pin(
        layout.ptr.data_ptr(), layout.idx.data_ptr(), q.data_ptr(),
        kt.data_ptr(), edge_w.data_ptr() if edge_w is not None else None,
        plan.data_ptr(), st.data_ptr(), out.data_ptr(), n, a, heads,
        fa.ATT_TYPES[att_type], float(ov2), float(inv2l2), float(ov2p),
        float(inv2l2p), fa._DTYPES[x.dtype],
        kvec, wpb, fa.ROW_SPLIT, nlong, nseg, _build.stream_ptr(x))
    _build.check(err, "attention_pin")
    _build.count_launch("attention_pin")
    return out
