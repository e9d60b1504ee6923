"""The redesigned SDDMM (``spmm.sddmm``: the edge-value gradient of the
laplacian SpMM, dw_e = g[row_e] . x[col_e]) on the CPU.

- The host's plan of the kernel's work items: the CSR rows of at most 32
  edges, then the 32-edge segments of the longer rows
  (``row_split_plan(ptr, 32, 32)``, read as row_walk.cuh's ``segment``
  reads it), cover every slot exactly once.
- The kernel's walk in plain PyTorch, in its order: per item, lane j
  holding edge j; each lane's f32 partial over the load vectors it holds
  (vector v on lane v mod 32, vectors of the host's ``gather_width``),
  chunk by chunk of 32 VPL vectors; a butterfly of the 32 partials per
  edge, ``SD_ROWS`` edges at a time, each chunk's sum added in the lane's
  register; one rounding to the output dtype; zeros past the slots. It is
  held to ``sddmm_plain`` and to graphax's ``_sddmm_call`` run in
  interpret mode (its blocked slots mapped back to edges), on a graph with
  empty rows, rows of 31, 32, 33 and 100 edges, one of 2,000 and padded
  slots, at D of 1, 7, 162 and 300, f32 and bf16 inputs.
- The autograd Function's value gradient (``_SpMM.backward``: the SDDMM in
  wb's dtype, its padding 0) against ``jax.grad`` of graphax's
  ``_make_spmm`` with respect to its blocked values.

Tolerances: f32 dot products of up to 300 terms of size about 1, summed
in another order, 1e-4 absolute and 1e-5 relative (chip_smoke's
TOL_DOT); an output rounded to bf16 from such sums one bf16 ulp (2^-7
relative) more, since the two sums can round to neighbours."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.kernels.dispatch import attach_tiles
from graphax.kernels.pallas_tiled import (
    _sddmm_call, _tile_rows, blocked_values, spmm_pallas,
)
from graphax.sparse import Graph as GxGraph

from graphax_torch.kernels import fused_attention as fa
from graphax_torch.kernels import spmm as spmm_mod
from graphax_torch.sparse.graph import Graph

DOT = dict(rtol=1e-5, atol=1e-4)
BF16 = dict(rtol=2.0 ** -7, atol=1e-4)
SD_ROWS = 2          # spmm.cu's x rows in flight
LONG = {3: 31, 5: 32, 8: 33, 13: 100, 21: 2000}
PAD = 11


def graphs(seed=0, n=60, e=300):
    """The same edges in both packages: the rows of ``LONG`` with their
    edge counts, the rest random (duplicates among them), rows 0 and 1 and
    the last 4 nodes without an edge, PAD padded slots; graphax's tiles of
    8 rows and 64-slot blocks."""
    rng = np.random.RandomState(seed)
    free = np.setdiff1d(np.arange(2, n - 4), list(LONG))
    row, col = [rng.choice(free, e)], [rng.choice(n - 4, e)]
    row[0][:20], col[0][:20] = row[0][20:40], col[0][20:40]
    for r, cnt in LONG.items():
        row.append(np.full(cnt, r))
        col.append(rng.choice(n - 4, cnt))
    row, col = np.concatenate(row), np.concatenate(col)
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    w = (rng.rand(row.size) + 0.2).astype(np.float32)
    size = row.size + PAD
    gx = attach_tiles(GxGraph.from_edges(row, col, n, edge_weight=w,
                                         edge_buffer_size=size),
                      tile=8, block_edges=64)
    pt = Graph.from_edges(row, col, n, edge_weight=w, edge_buffer_size=size)
    deg = np.diff(pt.csr.ptr.numpy())
    assert all(deg[r] == cnt for r, cnt in LONG.items())
    assert not deg[:2].any() and not deg[-4:].any()
    return gx, pt


def inputs(n, d, dtype, seed):
    """g and x [N, D] in ``dtype`` from a seed."""
    rng = np.random.RandomState(seed)
    tdt = getattr(torch, dtype)
    mk = lambda: torch.from_numpy(  # noqa: E731
        rng.randn(n, d).astype(np.float32)).to(tdt)
    return mk(), mk()


def items(ptr):
    """The kernel's work items (row, first slot, edges): the rows of 1 to
    32 edges, then each segment j of ``row_split_plan(ptr, 32, 32)`` as
    row_walk.cuh's ``segment`` reads it."""
    ptr = np.asarray(ptr, np.int64)
    plan, nlong, nseg = fa.row_split_plan(ptr, 32, 32)
    out = [(r, int(ptr[r]), int(ptr[r + 1] - ptr[r]))
           for r in range(ptr.size - 1) if 0 < ptr[r + 1] - ptr[r] <= 32]
    for j in range(nseg):
        i = plan[2 * nlong + 1 + j]
        r = int(plan[i])
        sb = int(ptr[r] + (j - plan[nlong + i]) * 32)
        out.append((r, sb, int(min(sb + 32, ptr[r + 1]) - sb)))
    return out


def _butterfly(v):
    """The xor butterfly over the last axis (32 lanes) in f32: lane 0's
    sum (every lane holds the same bits)."""
    lanes = torch.arange(v.shape[-1])
    o = v.shape[-1] // 2
    while o:
        v = v + v[..., lanes ^ o]
        o //= 2
    return v[..., 0]


def sddmm_walk(lay, g, x, out_dtype=torch.float32, length=None):
    """sddmm_kernel's walk in plain PyTorch."""
    n, d = x.shape
    vec = min(fa.gather_width(g), fa.gather_width(x)) // x.element_size()
    nvec = d // vec
    vpl = 1 if nvec <= 32 else 2 if nvec <= 64 else 3
    vi = torch.arange(d) // vec
    lane, chunk = vi % 32, vi // (32 * vpl)
    idx = lay.idx.long()
    dw = torch.zeros(lay.num_slots)
    for r, sb, cnt in items(lay.ptr.numpy()):
        prod = g[r].float() * x[idx[sb:sb + cnt]].float()     # [cnt, D]
        dot = torch.zeros(cnt)
        for c in range(int(chunk.max()) + 1 if d else 0):
            sel = chunk == c
            part = torch.zeros(cnt, 32).index_add_(1, lane[sel], prod[:, sel])
            for e0 in range(0, cnt, SD_ROWS):
                p = torch.zeros(SD_ROWS, 32)
                k = min(SD_ROWS, cnt - e0)
                p[:k] = part[e0:e0 + k]
                dot[e0:e0 + k] = dot[e0:e0 + k] + _butterfly(p)[:k]
        dw[sb:sb + cnt] = dot
    tail = (lay.num_slots if length is None else length) - lay.num_slots
    return torch.nn.functional.pad(dw.to(out_dtype), (0, tail))


def graphax_sddmm(gx, g, x):
    """graphax's ``_sddmm_call`` (interpreted) as ``_make_spmm``'s
    backward calls it, its real blocked slots mapped back to edges: [E]
    f32."""
    t = gx.tiles
    gj = jnp.asarray(g.float().numpy()).astype(str(g.dtype)[6:])
    xj = jnp.asarray(x.float().numpy()).astype(str(x.dtype)[6:])
    out = _sddmm_call(_tile_rows(gj, t.num_tiles, t.tile), xj[t.col],
                      t.local_row, t.tile_idx)
    mask = np.asarray(t.slot_mask)
    dw = np.zeros(int(gx.num_edges), np.float32)
    dw[np.asarray(t.edge_slot)[mask]] = np.asarray(out)[mask]
    return torch.from_numpy(dw)


def test_sddmm_items_cover_every_slot_once():
    _, pt = graphs()
    ptr = pt.csr.ptr.numpy()
    seen = np.zeros(pt.num_edges, np.int64)
    for r, sb, cnt in items(ptr):
        assert 0 < cnt <= 32 and ptr[r] <= sb and sb + cnt <= ptr[r + 1]
        seen[sb:sb + cnt] += 1
    assert (seen == 1).all()
    # 2,000 edges: 63 segments; 100: 4; 33: 2; the rows of 31 and 32 one
    _, nlong, nseg = fa.row_split_plan(ptr, 32, 32)
    assert (nlong, nseg) == (3, 63 + 4 + 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1, 7, 162, 300])
def test_sddmm_walk_matches_plain_and_graphax(dtype, d):
    gx, pt = graphs(seed=1)
    g, x = inputs(pt.num_nodes, d, dtype, seed=d)
    lay, e = pt.csr, pt.num_edges
    want = spmm_mod.sddmm_plain(lay, g, x)
    got = sddmm_walk(lay, g, x)
    torch.testing.assert_close(got, want, **DOT)
    torch.testing.assert_close(graphax_sddmm(gx, g, x), want, **DOT)
    # the CPU wrapper is the plain version
    assert torch.equal(spmm_mod.sddmm(lay, g, x), want)
    # the output dtype and the zeroed tail of an edge buffer
    tdt, size = getattr(torch, dtype), pt.edge_buffer_size
    low = sddmm_walk(lay, g, x, tdt, size)
    assert low.dtype == tdt and low.shape == (size,)
    assert torch.equal(low[e:], torch.zeros(PAD, dtype=tdt))
    plain = spmm_mod.sddmm_plain(lay, g, x, tdt, size)
    assert torch.equal(plain[:e], want.to(tdt))
    assert torch.equal(spmm_mod.sddmm(lay, g, x, tdt, size), plain)
    torch.testing.assert_close(low.float(), plain.float(),
                               **(DOT if dtype == "float32" else BF16))


def test_sddmm_wrapper_checks_length_and_out_dtype():
    _, pt = graphs(seed=2)
    g, x = inputs(pt.num_nodes, 5, "bfloat16", seed=2)
    with pytest.raises(ValueError, match="length"):
        spmm_mod.sddmm(pt.csr, g, x, length=pt.num_edges - 1)
    with pytest.raises(ValueError, match="out_dtype"):
        spmm_mod.sddmm(pt.csr, g, x, out_dtype=torch.float16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_value_gradient_matches_graphax_grad(dtype):
    """dw of the port's Function (the SDDMM in wb's dtype, padding 0)
    against ``jax.grad`` of graphax's custom VJP with respect to its
    blocked values, mapped back to edges; wb_t, which feeds dx only, is
    detached on the port's side (graphax gives it zeros)."""
    gx, pt = graphs(seed=3)
    n, d = pt.num_nodes, 162
    rng = np.random.RandomState(4)
    x = rng.randn(n, d).astype(np.float32)
    probe = rng.randn(n, d).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def loss(wb):
        wb_t = blocked_values(gx.edge_weight, gx.tiles_t).astype(jdt)
        y = spmm_pallas(wb, wb_t, jnp.asarray(x).astype(jdt), gx.tiles,
                        gx.tiles_t)
        return jnp.sum(y.astype(jnp.float32) * probe)

    dwb = jax.grad(loss)(blocked_values(gx.edge_weight, gx.tiles)
                         .astype(jdt))
    assert dwb.dtype == jdt
    mask = np.asarray(gx.tiles.slot_mask)
    want = np.zeros(pt.num_edges, np.float32)
    want[np.asarray(gx.tiles.edge_slot)[mask]] = np.asarray(
        dwb.astype(jnp.float32))[mask]

    wb = pt.edge_weight.to(tdt).requires_grad_(True)
    y = spmm_mod.spmm(pt, wb, spmm_mod.transpose_values(pt, wb.detach()),
                      torch.from_numpy(x).to(tdt))
    (y.float() * torch.from_numpy(probe)).sum().backward()
    e = pt.num_edges
    assert wb.grad.dtype == tdt and wb.grad.shape == (pt.edge_buffer_size,)
    assert torch.equal(wb.grad[e:], torch.zeros(PAD, dtype=tdt))
    torch.testing.assert_close(wb.grad[:e].float(), torch.from_numpy(want),
                               **(DOT if dtype == "float32" else BF16))
