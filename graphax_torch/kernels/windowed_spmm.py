"""The windowed (block-dense) SpMM: dense per-tile blocks built once per
forward, a batched product with the window slabs per solver evaluation, and
the CSR SpMM for the residual edges.

Replaces `graphax/kernels/pallas_windows.py`: `_densify_kernel` (:57),
`_win_matmul_kernel` (:185), `_win_bwd_dense_kernel` (:214) and
`_win_bwd_slab_kernel` (:243), with the custom VJPs of `_make_densify`
(:134-165) and `_make_win_matmul` (:293-348) and `spmm_windowed`
(:351-374). The CUDA source is `csrc/windowed_spmm.cu`; the layout is
`graphax_torch.kernels.windows.WindowLayout`. Each wrapper takes a CUDA
tensor to its kernel and a CPU tensor to the plain PyTorch version beside
it, never falls back from one to the other, checks its operands and counts
its launches in ``_build.LAUNCHES``.

Numerics, as graphax's: the blocks hold the edge values rounded once to the
state dtype; the in-window product sums in f32 (bf16 products are exact in
f32), then adds the residual SpMM's result (already in the state dtype)
and rounds once to the state dtype, as graphax's `spmm_windowed` does
(:366-374); the backward casts the cotangent to the state dtype before
both products, returns ``d_dense`` in the blocks' dtype (graphax's f32
result cast, `:330-331`: `win_bwd_dense` rounds its f32 sums once to that
dtype in its epilogue, with no pass over an f32 copy) and ``dx`` in the
state dtype (graphax's ``d_slab[:N].astype``, `:343-344`: `win_bwd_slab`
writes the first N slab rows rounded once, with no f32 slab and no cast
pass). The backward's Functions (`_WinBwdSlab`, `_WinBwdDense`) are
differentiable in turn, on the same three kernels."""

from __future__ import annotations

import torch

from graphax_torch.kernels import _build
from graphax_torch.kernels.spmm import spmm_layouts
from graphax_torch.kernels.windows import WindowLayout

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _slab(x: torch.Tensor, wl: WindowLayout) -> torch.Tensor:
    """``x`` padded with zero rows to ``[Wn, W, D]``."""
    pad = wl.num_windows * wl.window - x.shape[0]
    xp = torch.cat([x, x.new_zeros(pad, x.shape[1])]) if pad else x
    return xp.reshape(wl.num_windows, wl.window, -1)


def _tiles(g: torch.Tensor, wl: WindowLayout) -> torch.Tensor:
    """``g [N, D]`` padded with zero rows to ``[T, tile, D]``."""
    pad = wl.num_tiles * wl.tile - g.shape[0]
    gp = torch.cat([g, g.new_zeros(pad, g.shape[1])]) if pad else g
    return gp.reshape(wl.num_tiles, wl.tile, -1)


def _check(wl: WindowLayout, what: str, x: torch.Tensor, *others):
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported")
    for t in (x,) + others + (wl.tile_win,):
        if t.device != x.device:
            raise ValueError(f"{what}: all operands must be on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    for t in others:
        if t.dtype != x.dtype:
            raise TypeError(f"{what}: operands must share x's dtype")


def _check_rows(wl: WindowLayout, what: str, t: torch.Tensor):
    if t.dim() != 2 or t.shape[0] != wl.num_nodes:
        raise ValueError(f"{what}: expected [N, D] with N = {wl.num_nodes}, "
                         f"got {tuple(t.shape)}")


def f32_copy_values(extent: int, *ts: torch.Tensor) -> int:
    """How many f32 values one copy (or access) of the f32 kernels moves
    along rows of ``extent`` values of ``ts``: 4 (16 bytes) where the
    extent divides by 4 and every tensor starts on 16 bytes, 2 (8 bytes)
    where it is even and they start on 8, else 1."""
    for v in (4, 2):
        if extent % v == 0 and all(t.data_ptr() % (4 * v) == 0 for t in ts):
            return v
    return 1


def _f32_staging(va: int, vb: int) -> str:
    """The f32 route's name: CUDA-core FMAs, and the bytes a cp.async
    copy of A and of B moves."""
    return f"fma cp.async {4 * va}/{4 * vb}"


def _check_blocks(wl: WindowLayout, what: str, dense: torch.Tensor):
    if tuple(dense.shape) != wl.block_shape:
        raise ValueError(f"{what}: blocks must be {wl.block_shape}, got "
                         f"{tuple(dense.shape)}")


# ----------------------------------------------------------------------
# densify: in-window edge values -> dense [T, tile, W] blocks
# ----------------------------------------------------------------------

def densify_plain(wl: WindowLayout, values, dtype) -> torch.Tensor:
    dense = torch.zeros(wl.num_tiles * wl.tile * wl.window, dtype=dtype,
                        device=values.device)
    dense[wl.win_cell.long()] = values[wl.win_edge.long()].to(dtype)
    return dense.reshape(wl.block_shape)


def densify(wl: WindowLayout, values: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """``[T, tile, W]`` blocks in ``dtype``: each in-window edge's value
    (``values`` indexed by edge buffer position) at its cell, 0 elsewhere."""
    if not values.is_cuda:
        return densify_plain(wl, values, dtype)
    if values.dtype not in _DTYPES or dtype not in _DTYPES:
        raise TypeError("densify: float32 or bfloat16 values and blocks")
    if values.dim() != 1 or not values.is_contiguous():
        raise ValueError("densify: values must be 1-D and contiguous")
    for t in (wl.win_edge, wl.win_cell):
        if t.device != values.device:
            raise ValueError(f"densify: layout must be on {values.device}")
    dense = torch.empty(wl.block_shape, dtype=dtype, device=values.device)
    err = _build.library("windowed_spmm").gx_densify(
        wl.win_edge.data_ptr(), wl.win_cell.data_ptr(), values.data_ptr(),
        dense.data_ptr(), wl.in_window_edges, dense.numel(),
        _DTYPES[values.dtype], _DTYPES[dtype], _build.stream_ptr(values))
    _build.check(err, "densify")
    _build.count_launch("windowed_densify")
    return dense


class _Densify(torch.autograd.Function):
    """The backward is the transpose: a gather of the cotangent at each
    in-window edge's cell (plain indexing, as graphax does it in XLA)."""

    @staticmethod
    def forward(ctx, values, wl, dtype):
        ctx.wl = wl
        ctx.values_meta = (values.shape, values.dtype)
        return densify(wl, values.contiguous(), dtype)

    @staticmethod
    def backward(ctx, g):
        wl = ctx.wl
        shape, dtype = ctx.values_meta
        dv = torch.zeros(shape, dtype=dtype, device=g.device)
        dv[wl.win_edge.long()] = g.reshape(-1)[wl.win_cell.long()].to(dtype)
        return dv, None, None


def densify_windows(values: torch.Tensor, wl: WindowLayout,
                    dtype: torch.dtype) -> torch.Tensor:
    """Differentiable :func:`densify` (once per forward)."""
    return _Densify.apply(values, wl, dtype)


# ----------------------------------------------------------------------
# win_matmul: out[t] = dense[t] @ slab[tile_win[t]]
# ----------------------------------------------------------------------

def win_matmul_plain(wl: WindowLayout, dense, x, addend):
    slab = _slab(x.float(), wl)[wl.tile_win.long()]          # [T, W, D]
    out = torch.bmm(dense.float(), slab)                       # [T, tile, D]
    out = out.reshape(wl.num_tiles * wl.tile, -1)[:wl.num_nodes]
    return (out + addend.float()).to(x.dtype)


def matmul_staging(dense: torch.Tensor, x: torch.Tensor,
                   addend: torch.Tensor) -> str:
    """How the kernel stages its operands. bf16: ``"cp.async"`` (16-byte
    copies of the blocks' rows, 4-byte copies of the column pairs of x's
    and the addend's rows, the output written in pairs) where W is a
    multiple of 8, D is even, the blocks start on 16 bytes and x and the
    addend on 4; else ``"elements"`` (one value per copy: odd D, W off 8,
    or a view such as ``x.view(-1)[1:]`` that starts mid-pair). f32:
    ``"fma cp.async 4/<b>"``, the blocks by 4-byte copies of one value
    (transposed into k-major rows), x's rows by ``b`` = 16, 8 or 4 bytes
    (:func:`f32_copy_values` of x and the addend, which also sizes the
    epilogue's addend loads and output stores). Every route gives the same
    values."""
    if x.dtype == torch.float32:
        return _f32_staging(1, f32_copy_values(x.shape[1], x, addend))
    ok = (dense.shape[-1] % 8 == 0 and x.shape[1] % 2 == 0
          and dense.data_ptr() % 16 == 0 and x.data_ptr() % 4 == 0
          and addend.data_ptr() % 4 == 0)
    return "cp.async" if ok else "elements"


def win_matmul(wl: WindowLayout, dense: torch.Tensor, x: torch.Tensor,
               addend: torch.Tensor) -> torch.Tensor:
    """``[N, D]`` in x's dtype: the in-window product of the blocks with x,
    summed in f32, plus ``addend`` (``[N, D]`` in x's dtype), rounded once
    to x's dtype (the kernel adds it in its epilogue). bf16 runs on the
    tensor cores, f32 on CUDA-core FMAs (:func:`matmul_staging` names how
    either stages)."""
    if not x.is_cuda:
        return win_matmul_plain(wl, dense, x, addend)
    _check(wl, "win_matmul", x, dense, addend)
    _check_rows(wl, "win_matmul", x)
    _check_blocks(wl, "win_matmul", dense)
    n, d = x.shape
    if addend.shape != x.shape:
        raise ValueError("win_matmul: addend must be shaped like x")
    out = torch.empty((n, d), device=x.device, dtype=x.dtype)
    if x.dtype == torch.bfloat16:
        va, vb = int(matmul_staging(dense, x, addend) == "cp.async"), 0
    else:
        va, vb = 1, f32_copy_values(d, x, addend)
    err = _build.library("windowed_spmm").gx_win_matmul(
        dense.data_ptr(), x.data_ptr(), wl.tile_win.data_ptr(),
        addend.data_ptr(), out.data_ptr(),
        wl.num_tiles, wl.tile, wl.window, n, d, _DTYPES[x.dtype], va, vb,
        _build.stream_ptr(x))
    _build.check(err, "win_matmul")
    _build.count_launch("win_matmul")
    return out


# ----------------------------------------------------------------------
# win_bwd_dense: d_dense[t] = g[t] @ slab[tile_win[t]]^T
# ----------------------------------------------------------------------

def win_bwd_dense_plain(wl: WindowLayout, g, x,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    slab = _slab(x.float(), wl)[wl.tile_win.long()]          # [T, W, D]
    out = torch.bmm(_tiles(g.float(), wl), slab.transpose(1, 2))
    return out.to(out_dtype)


def bwd_dense_staging(g: torch.Tensor, x: torch.Tensor) -> str:
    """How the kernel stages its g and slab rows. bf16: ``"cp.async"``
    (16-byte copies of each block's contiguous rows) where both start on
    16 bytes and D is even, else ``"elements"`` (one value per copy: odd
    D, or a view such as ``x[1:]`` that starts mid-row). f32: ``"fma
    cp.async 4/4"`` at every shape: both by 4-byte copies of one value,
    transposed into k-major rows. Every route gives the same values."""
    if x.dtype == torch.float32:
        return _f32_staging(1, 1)
    ok = (x.shape[1] % 2 == 0 and g.data_ptr() % 16 == 0
          and x.data_ptr() % 16 == 0)
    return "cp.async" if ok else "elements"


def win_bwd_dense(wl: WindowLayout, g: torch.Tensor, x: torch.Tensor,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[T, tile, W]`` in ``out_dtype``: the gradient of the blocks, f32
    sums rounded once (bf16: to nearest even, the bits of the f32 result
    cast). bf16 inputs run on the tensor cores, f32 inputs on CUDA-core
    FMAs (:func:`bwd_dense_staging` names how either stages)."""
    if not x.is_cuda:
        return win_bwd_dense_plain(wl, g, x, out_dtype)
    _check(wl, "win_bwd_dense", x, g)
    _check_rows(wl, "win_bwd_dense", x)
    _check_rows(wl, "win_bwd_dense", g)
    if out_dtype not in _DTYPES:
        raise TypeError(f"win_bwd_dense: out_dtype {out_dtype} not supported")
    n, d = x.shape
    va = vb = int(bwd_dense_staging(g, x) == "cp.async")
    out = torch.empty(wl.block_shape, dtype=out_dtype, device=x.device)
    err = _build.library("windowed_spmm").gx_win_bwd_dense(
        g.data_ptr(), x.data_ptr(), wl.tile_win.data_ptr(), out.data_ptr(),
        wl.num_tiles, wl.tile, wl.window, n, d, _DTYPES[x.dtype],
        _DTYPES[out_dtype], va, vb, _build.stream_ptr(x))
    _build.check(err, "win_bwd_dense")
    _build.count_launch("win_bwd_dense")
    return out


# ----------------------------------------------------------------------
# win_bwd_slab: d_slab[w] = sum over tiles t of window w of dense[t]^T g[t]
# ----------------------------------------------------------------------

def win_bwd_slab_plain(wl: WindowLayout, dense, g,
                       out_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """graphax's ``d_slab[:N].astype(out_dtype)``: the per-tile products
    summed into their windows in f32, the first N slab rows, one
    rounding."""
    per_tile = torch.bmm(dense.float().transpose(1, 2),
                         _tiles(g.float(), wl))                # [T, W, D]
    out = torch.zeros((wl.num_windows, wl.window, g.shape[1]),
                      dtype=torch.float32, device=g.device)
    out.index_add_(0, wl.tile_win.long(), per_tile)
    return out.reshape(wl.num_windows * wl.window, -1)[:wl.num_nodes] \
        .to(out_dtype)


def slab_staging(dense: torch.Tensor, g: torch.Tensor) -> str:
    """How the kernel stages its operands. bf16: ``"cp.async"`` (16-byte
    copies of the blocks' rows, 4-byte copies of the column pairs of g's
    rows, the output written in pairs) where W is a multiple of 8, D is
    even, the blocks start on 16 bytes and g on 4; else ``"elements"``
    (one value per copy: odd D, W off 8, or a view that starts mid-pair):
    the rule of :func:`matmul_staging`, g in x's place. f32: ``"fma
    cp.async <a>/<b>"``, the blocks' rows and g's rows (both k-major as
    they are) by ``a`` and ``b`` = 16, 8 or 4 bytes
    (:func:`f32_copy_values` along W and D; ``b`` also sizes the output
    stores). Every route gives the same values."""
    if g.dtype == torch.float32:
        return _f32_staging(f32_copy_values(dense.shape[-1], dense),
                            f32_copy_values(g.shape[1], g))
    return matmul_staging(dense, g, g)


def win_bwd_slab(wl: WindowLayout, dense: torch.Tensor, g: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[N, D]`` in ``out_dtype``: the gradient of the slab at its first N
    rows (the nodes), f32 sums rounded once (bf16: to nearest even, the
    bits of the f32 result cast). A window that no tile maps gives zeros.
    bf16 runs on the tensor cores, f32 on CUDA-core FMAs
    (:func:`slab_staging` names how either stages)."""
    if not g.is_cuda:
        return win_bwd_slab_plain(wl, dense, g, out_dtype)
    _check(wl, "win_bwd_slab", g, dense)
    _check_rows(wl, "win_bwd_slab", g)
    _check_blocks(wl, "win_bwd_slab", dense)
    if out_dtype not in _DTYPES:
        raise TypeError(f"win_bwd_slab: out_dtype {out_dtype} not supported")
    for t in (wl.win_ptr, wl.win_tiles):
        if t.device != g.device:
            raise ValueError(f"win_bwd_slab: layout must be on {g.device}")
    n, d = g.shape
    if g.dtype == torch.bfloat16:
        va, vb = int(slab_staging(dense, g) == "cp.async"), 0
    else:
        va = f32_copy_values(wl.window, dense)
        vb = f32_copy_values(d, g)
    out = torch.empty((n, d), dtype=out_dtype, device=g.device)
    err = _build.library("windowed_spmm").gx_win_bwd_slab(
        dense.data_ptr(), g.data_ptr(), wl.win_ptr.data_ptr(),
        wl.win_tiles.data_ptr(), out.data_ptr(), wl.num_windows, wl.tile,
        wl.window, n, d, _DTYPES[g.dtype], _DTYPES[out_dtype], va, vb,
        _build.stream_ptr(g))
    _build.check(err, "win_bwd_slab")
    _build.count_launch("win_bwd_slab")
    return out


class _WinMatmul(torch.autograd.Function):
    """``out = blocks x + addend``, rounded to x's dtype, with ``dx`` from
    `win_bwd_slab`, the addend's gradient passed through, and, only when the
    blocks need a gradient, ``d_dense`` from `win_bwd_dense`. The backward
    is itself differentiable: ``dx`` and ``d_dense`` come through
    :class:`_WinBwdSlab` and :class:`_WinBwdDense`, whose own backwards are
    these three kernels again (a first derivative launches what it would
    without that)."""

    @staticmethod
    def forward(ctx, dense, x, wl, addend):
        ctx.wl = wl
        ctx.save_for_backward(dense, x)
        return win_matmul(wl, dense, x, addend)

    @staticmethod
    def backward(ctx, g):
        dense, x = ctx.saved_tensors
        wl = ctx.wl
        g = g.to(x.dtype).contiguous()
        d_dense = dx = None
        if ctx.needs_input_grad[1]:
            blocks = dense.to(x.dtype).contiguous()
            dx = _WinBwdSlab.apply(blocks, g, wl, x.dtype)
        if ctx.needs_input_grad[0]:
            d_dense = _WinBwdDense.apply(g, x, wl, dense.dtype)
        return d_dense, dx, None, g


class _WinBwdSlab(torch.autograd.Function):
    """``dx = blocks^T g`` (`win_bwd_slab`), differentiable: for a
    cotangent ``h [N, D]``, ``d_blocks = g h^T`` per tile (`win_bwd_dense`)
    and ``dg = blocks h`` (`win_matmul`)."""

    @staticmethod
    def forward(ctx, dense, g, wl, out_dtype):
        ctx.wl = wl
        ctx.save_for_backward(dense, g)
        return win_bwd_slab(wl, dense, g, out_dtype)

    @staticmethod
    def backward(ctx, h):
        dense, g = ctx.saved_tensors
        wl = ctx.wl
        h = h.to(g.dtype).contiguous()
        d_dense = dg = None
        if ctx.needs_input_grad[0]:
            d_dense = _WinBwdDense.apply(g, h, wl, dense.dtype)
        if ctx.needs_input_grad[1]:
            dg = _WinMatmul.apply(dense.to(g.dtype).contiguous(), h, wl,
                                  torch.zeros_like(h))
        return d_dense, dg, None, None


class _WinBwdDense(torch.autograd.Function):
    """``d_blocks = g x^T`` per tile (`win_bwd_dense`), differentiable: for
    a cotangent ``c [T, tile, W]``, ``dg = c x`` (`win_matmul`) and ``dx =
    c^T g`` (`win_bwd_slab`)."""

    @staticmethod
    def forward(ctx, g, x, wl, out_dtype):
        ctx.wl = wl
        ctx.save_for_backward(g, x)
        return win_bwd_dense(wl, g, x, out_dtype)

    @staticmethod
    def backward(ctx, c):
        g, x = ctx.saved_tensors
        wl = ctx.wl
        c = c.to(x.dtype).contiguous()
        dg = dx = None
        if ctx.needs_input_grad[0]:
            dg = _WinMatmul.apply(c, x, wl, torch.zeros_like(x))
        if ctx.needs_input_grad[1]:
            dx = _WinBwdSlab.apply(c, g, wl, x.dtype)
        return dg, dx, None, None


def spmm_windowed(dense: torch.Tensor, res_wb: torch.Tensor,
                  res_wb_t: torch.Tensor, x: torch.Tensor,
                  wl: WindowLayout) -> torch.Tensor:
    """Differentiable ``A @ x`` on the windowed layout, in x's dtype.

    ``dense``: the blocks from :func:`densify_windows`; ``res_wb`` /
    ``res_wb_t``: the residual edges' values in x's dtype, in the slot
    orders of ``wl.residual`` / ``wl.residual_t``. The residual SpMM's
    result (in x's dtype) is added to the f32 in-window sum in
    `win_matmul`'s epilogue, with one rounding to x's dtype."""
    x = x.contiguous()
    res = spmm_layouts(wl.residual, wl.residual_t, res_wb, res_wb_t, x)
    return _WinMatmul.apply(dense, x, wl, res)
