"""CSR SpMM and SDDMM: the laplacian RHS's sparse product and its gradient.

Replaces `graphax/kernels/pallas_tiled.py` (`_spmm_kernel` :79 and
`_sddmm_kernel` :146 with the custom VJP of `_make_spmm` :216-255). The CUDA
sources are `csrc/spmm.cu`. Each wrapper:

- takes a CUDA tensor to its kernel and a CPU tensor to the plain PyTorch
  version beside it, and never falls back from one to the other;
- checks device, dtype, shape and contiguity and raises on what the kernel
  does not take;
- counts its launches in ``_build.LAUNCHES``.

The SpMM kernel walks the CSR as `fused_attention`'s row walk does (a warp
per row, batches of 32 edges, several gathered rows in flight, rows of
more than ``fused_attention.ROW_SPLIT`` edges in segments of that many,
summed in order), all of D in one pass.

The SDDMM kernel takes the rows of at most 32 edges and the 32-edge
segments of the longer rows, a warp each, several gathered x rows in
flight against g's row in registers, and writes a batch's 32 values in one
store.

The autograd Functions (`_SpMM`, `_SDDMM`) take their backwards through
each other, so a loss that holds a vjp of the RHS (the regularisers,
`graphax_torch.functions.regularizers`) is differentiated again on the
same kernels.

Numerics (both versions): each product ``w_e * x[idx_e]`` is rounded to the
state dtype, sums accumulate in f32 and are cast once to the state dtype;
rows with no edge give 0; the SDDMM accumulates in f32 and rounds once to
its output dtype (f32 unless asked; the Function's backward asks for the
values' dtype, graphax's ``.astype(wb.dtype)``)."""

from __future__ import annotations

import weakref

import torch

from graphax_torch.kernels import _build
from graphax_torch.kernels import fused_attention as fa
from graphax_torch.sparse.graph import Graph, Layout

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(layout: Layout, a: torch.Tensor, x: torch.Tensor, what: str):
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be [N, D], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported")
    for name, t in (("ptr", layout.ptr), ("idx", layout.idx)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{what}: layout.{name} must be contiguous int32")
    for t in (layout.ptr, layout.idx, a):
        if t.device != x.device:
            raise ValueError(f"{what}: all operands must be on {x.device}")
    if not x.is_contiguous() or not a.is_contiguous():
        raise ValueError(f"{what}: operands must be contiguous")


def spmm_csr_plain(layout: Layout, values, x, num_rows: int):
    """y[r] = sum over slots j of row r of values[j] * x[idx[j]]."""
    prod = x[layout.idx.long()] * values[:layout.num_slots].to(x.dtype)[:, None]
    out = torch.zeros((num_rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    return out.index_add_(0, layout.seg, prod.float()).to(x.dtype)


def spmm_csr(layout: Layout, values: torch.Tensor, x: torch.Tensor,
             num_rows: int) -> torch.Tensor:
    """``[num_rows, D]`` in x's dtype; ``values`` hold one entry per slot of
    ``layout`` (at least ``layout.num_slots``), in x's dtype."""
    if not x.is_cuda:
        return spmm_csr_plain(layout, values, x, num_rows)
    _check(layout, values, x, "spmm_csr")
    if values.dtype != x.dtype or values.dim() != 1 \
            or values.shape[0] < layout.num_slots:
        raise ValueError("spmm_csr: values must be 1-D in x's dtype with one "
                         "entry per slot")
    if layout.num_rows != num_rows:
        raise ValueError("spmm_csr: layout and num_rows disagree")
    d = x.shape[1]
    y = torch.empty((num_rows, d), dtype=x.dtype, device=x.device)
    plan, nlong, nseg = fa._row_plan(layout, fa.ROW_SPLIT, fa.ROW_SPLIT)
    part = torch.empty((nseg, d), dtype=torch.float32, device=x.device)
    lib = _build.library("spmm")
    err = lib.gx_spmm_csr(layout.ptr.data_ptr(), layout.idx.data_ptr(),
                          values.data_ptr(), x.data_ptr(), y.data_ptr(),
                          plan.data_ptr(), part.data_ptr(), num_rows, d,
                          _DTYPES[x.dtype], fa.gather_width(x),
                          fa.ROW_SPLIT, nlong, nseg, _build.stream_ptr(x))
    _build.check(err, "spmm_csr")
    _build.count_launch("spmm_csr")
    return y


def sddmm_plain(layout: Layout, g, x, out_dtype=torch.float32,
                length: int | None = None):
    """out[j] = g[seg[j]] . x[idx[j]] in f32, one value per slot, cast once
    to ``out_dtype``; ``length`` entries with zeros past the slots."""
    dw = (g[layout.seg].float() * x[layout.idx.long()].float()).sum(-1)
    n = layout.num_slots
    return torch.nn.functional.pad(dw.to(out_dtype),
                                   (0, (n if length is None else length) - n))


def sddmm(layout: Layout, g: torch.Tensor, x: torch.Tensor,
          out_dtype=torch.float32, length: int | None = None) -> torch.Tensor:
    """``[length]`` per-slot dot products ``g[row] . x[col]`` (``length``
    at least ``layout.num_slots``, its default; 0 past the slots): f32
    sums rounded once to ``out_dtype``, float32 or x's dtype. The kernel
    takes the rows of at most 32 edges a warp each, the longer ones in
    32-edge segments (``fused_attention.row_split_plan``)."""
    n = layout.num_slots
    length = n if length is None else length
    if length < n:
        raise ValueError(f"sddmm: length {length} < {n} slots")
    fa._out_dtype("sddmm", x, out_dtype)
    if not x.is_cuda:
        return sddmm_plain(layout, g, x, out_dtype, length)
    _check(layout, g, x, "sddmm")
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError("sddmm: g and x must share shape and dtype")
    out = torch.empty(length, dtype=out_dtype, device=x.device)
    plan, nlong, nseg = fa._row_plan(layout, fa._BATCH, fa._BATCH)
    lib = _build.library("spmm")
    err = lib.gx_sddmm_csr(layout.ptr.data_ptr(), layout.idx.data_ptr(),
                           g.data_ptr(), x.data_ptr(), plan.data_ptr(),
                           out.data_ptr(), layout.num_rows, x.shape[1],
                           _DTYPES[x.dtype],
                           min(fa.gather_width(g), fa.gather_width(x)),
                           int(out_dtype == torch.bfloat16), nlong, nseg, n,
                           length, _build.stream_ptr(x))
    _build.check(err, "sddmm")
    _build.count_launch("sddmm")
    return out


# by id of a layout's ``idx``: that tensor and its partner's (weakly) and
# the slot map from the partner; an entry goes when the layout's ``idx``
# does (a tensor compares by value, so it cannot key a WeakKeyDictionary)
_SLOT_MAPS: dict = {}


def _transpose_slots(a: Layout, b: Layout) -> torch.Tensor:
    """Each slot of ``b``'s slot in ``a``, two layouts of the same edges
    (a CSR and its CSC): their ``perm`` name each slot's edge position,
    the slot itself where ``perm`` is None. Computed once per pair and
    kept while ``b`` lives, finished before any stream reads it
    (``_build.publish``)."""
    hit = _SLOT_MAPS.get(id(b.idx))
    if hit is not None and hit[0]() is b.idx and hit[1]() is a.idx:
        return hit[2]
    pos_a = a.perm if a.perm is not None else torch.arange(
        a.num_slots, device=a.idx.device)
    pos_b = b.perm if b.perm is not None else torch.arange(
        b.num_slots, device=b.idx.device)
    pos, order = torch.sort(pos_a)
    slots = _build.publish(order[torch.searchsorted(pos, pos_b)])
    if hit is None:
        weakref.finalize(b.idx, _SLOT_MAPS.pop, id(b.idx), None)
    _SLOT_MAPS[id(b.idx)] = (weakref.ref(b.idx), weakref.ref(a.idx), slots)
    return slots


class _SpMM(torch.autograd.Function):
    """``y = A x`` over the slots of ``csr`` with ``dx = A^T g`` (the same
    kernel on ``csc``, the transpose of the same edges) and, only when asked
    for, ``dw`` through the SDDMM. ``wb`` holds one value per CSR slot (or
    more: the rest, a graph's padding, gets a zero gradient).

    The backward is itself differentiable, on the same kernels: ``dx`` is
    this Function on the swapped layouts, ``dw`` :class:`_SDDMM`. A first
    derivative launches what it would without that (the Functions run
    their forward alone when no graph is recorded); under ``create_graph``
    the transposed values are taken from ``wb`` itself where ``wb`` needs a
    gradient, so ``A^T``'s dependence on them reaches it."""

    @staticmethod
    def forward(ctx, wb, wb_t, x, csr, csc):
        ctx.layouts = (csr, csc)
        ctx.save_for_backward(wb, wb_t, x)
        return spmm_csr(csr, wb, x, csr.num_rows)

    @staticmethod
    def backward(ctx, g):
        wb, wb_t, x = ctx.saved_tensors
        csr, csc = ctx.layouts
        g = g.to(x.dtype).contiguous()
        dwb = dx = None
        if ctx.needs_input_grad[2]:
            if torch.is_grad_enabled() and ctx.needs_input_grad[0]:
                wb_t = wb[_transpose_slots(csr, csc)]
            dx = _SpMM.apply(wb_t, wb, g, csc, csr)
        if ctx.needs_input_grad[0]:
            dwb = _SDDMM.apply(g, x, csr, csc, wb.dtype, wb.shape[0])
        return dwb, None, dx, None, None


class _SDDMM(torch.autograd.Function):
    """``c = sddmm(csr, g, x)``, one value per CSR slot, differentiable:
    for a cotangent ``c'`` on the slots, ``dg = A(c') x`` (the SpMM over
    ``csr`` with the values ``c'``) and ``dx = A(c')^T g`` (over ``csc``),
    both through :class:`_SpMM`, so every order runs on the hand-written
    kernels."""

    @staticmethod
    def forward(ctx, g, x, csr, csc, out_dtype, length):
        ctx.layouts = (csr, csc)
        ctx.save_for_backward(g, x)
        return sddmm(csr, g, x, out_dtype, length)

    @staticmethod
    def backward(ctx, c):
        g, x = ctx.saved_tensors
        csr, csc = ctx.layouts
        c = c[:csr.num_slots].to(x.dtype).contiguous()
        c_t = c[_transpose_slots(csr, csc)].contiguous()
        dg = dx = None
        if ctx.needs_input_grad[0]:
            dg = _SpMM.apply(c, c_t, x, csr, csc)
        if ctx.needs_input_grad[1]:
            dx = _SpMM.apply(c_t, c, g, csc, csr)
        return dg, dx, None, None, None, None


def transpose_values(graph: Graph, wb: torch.Tensor) -> torch.Tensor:
    """Edge values in the CSC slot order (once per forward)."""
    return wb[graph.csc.perm].contiguous()


def spmm(graph: Graph, wb: torch.Tensor, wb_t: torch.Tensor,
         x: torch.Tensor) -> torch.Tensor:
    """Differentiable ``A @ x``: ``wb [E_pad]`` edge values in x's dtype
    (0 on padding) and ``wb_t = transpose_values(graph, wb)``."""
    return spmm_layouts(graph.csr, graph.csc, wb, wb_t, x)


def spmm_layouts(csr: Layout, csc: Layout, wb: torch.Tensor,
                 wb_t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Differentiable product over one CSR/CSC pair of the same edges (a
    whole graph, or the windowed layout's residual): ``wb`` per CSR slot,
    ``wb_t`` per CSC slot, both in x's dtype."""
    return _SpMM.apply(wb, wb_t, x.contiguous(), csr, csc)
