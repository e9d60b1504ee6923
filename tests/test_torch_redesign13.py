"""The redesigned windowed attention kernel (K5, ``winatt``) and
``attention_gmax``, on the CPU.

- The host side of the new kernels against direct constructions: the
  slot-to-row table gmax reads (``layout.seg``) against ``np.repeat`` of
  the CSR's row lengths; K5's plan of its long rows' segments; K5's gate,
  which admits every shape the previous gate (a staged q row per warp)
  admitted; the 16-byte load flags of both kernels.
- The kernels' walks in plain PyTorch against the plain versions: K5's
  group of 16 lanes a row (the kernel's ``LANES``), one cell a lane and
  the butterfly of width 16, longer rows in segments of 32 cells combined
  in segment order; gmax's (slot, head) pairs scored from ``q[seg[e]]`` and
  ``K[idx[e]]``.
- ``winatt_plain`` against graphax's K5 (`_winatt_call`) in interpret mode
  on a windowed graph with an in-window row of exactly 32 cells, one of
  33, one of W (every cell of its window) and rows with none.
- ``attention_gmax_plain`` against graphax's `_gmax_call` in interpret mode
  on a tiled layout with padded slots and a padded edge buffer, every
  score type, with and without reweight, and with every score at or below
  NEG/2 (the result 0).

Tolerances: f32 values rtol 2e-4 / atol 2e-5 (graphax's attention
tolerance: sums and exp in another order); K5's bf16 output 2e-2 relative
plus two bf16 ulps (2^-6) of the largest x (a weight rounded to bf16 at the
margin moves one term by one ulp), its den in f32 at the f32 tolerance;
the walks against the plain versions at the same tolerances; the walk at
16 lanes and the parent's warp of 32 lanes a row (the same walk at 32)
equal bit for bit on rows of at most 16 cells (the same operations in the
same order)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.kernels import pallas_tiled, pallas_windows
from graphax.kernels.dispatch import attach_tiles
from graphax.kernels.dispatch import attach_windows as gx_attach_windows
from graphax.kernels.pallas_attention import _gmax_call, _prep_inputs
from graphax.kernels.pallas_winatt import _slab_pad, _winatt_call
from graphax.sparse import Graph as GxGraph
from graphax.train import Config as GxConfig
from graphax.functions.transformer import transformer_attention_init

from graphax_torch.functions.transformer import TransformerAttention
from graphax_torch.kernels import fused_attention as fa
from graphax_torch.kernels import winatt as wa
from graphax_torch.kernels.dispatch import attach_windows
from graphax_torch.sparse.graph import Graph
from graphax_torch.train import Config
from graphax_torch.utils.transplant import load_graphax_params

ATT_TYPES = ["scaled_dot", "cosine_sim", "pearson", "exp_kernel"]
F32 = dict(rtol=2e-4, atol=2e-5)
TILE, WINDOW = 8, 64
OV2, INV2L2 = 1.3, 0.7


@pytest.fixture(autouse=True)
def _force_pallas(monkeypatch):
    monkeypatch.setattr(pallas_windows, "FORCE", True)
    monkeypatch.setattr(pallas_tiled, "FORCE", True)


def _bf16_tol(x):
    return dict(rtol=2e-2, atol=2.0 ** -6 * float(x.float().abs().max()))


def k5_graphs(seed=0, n=128, pad=5):
    """The same windowed graph in both packages (two windows of 64, tiles
    of 8): in-window row 3 of exactly 32 cells, row 10 of 33, row 70 of 64
    (its whole window), rows 40 and 41 of none (out-of-window edges only),
    rows 126 and 127 without an edge."""
    rng = np.random.RandomState(seed)
    comm = np.arange(n) // WINDOW
    same = comm[:, None] == comm[None, :]
    hit = rng.rand(n, n) < np.where(same, 0.12, 0.03)
    for r, cells in ((3, 32), (10, 33), (70, WINDOW)):
        hit[r] &= ~same[r]
        hit[r, comm[r] * WINDOW + rng.choice(WINDOW, cells, replace=False)] \
            = True
    hit[40:42] &= ~same[40:42]
    hit[40, 100] = hit[41, 90] = True
    hit[n - 2:] = False
    row, col = np.nonzero(hit)
    w = (rng.rand(len(row)) + 0.2).astype(np.float32)
    e = len(row)
    gx = gx_attach_windows(
        GxGraph.from_edges(row, col, n, edge_weight=w,
                           edge_buffer_size=e + pad),
        window=WINDOW, tile=TILE, block_edges=16, hubs=False)
    pt = attach_windows(
        Graph.from_edges(row, col, n, edge_weight=w, edge_buffer_size=e + pad),
        window=WINDOW, tile=TILE)
    deg = np.diff(pt.windows.in_window.ptr.numpy())
    assert (deg[3], deg[10], deg[70]) == (32, 33, WINDOW)
    assert deg[40] == deg[41] == deg[126] == deg[127] == 0
    return gx, pt


def k5_inputs(pt, dtype, seed, a=8, heads=2, d=5):
    """q, k [N, A] and x [N, D] in ``dtype``, d_res [N, H] (tile 0's rows
    zero), r0, and per-cell weights rounded to ``dtype``, from a seed."""
    rng = np.random.RandomState(seed)
    n = pt.num_nodes
    tdt = getattr(torch, dtype)
    mk = lambda *s, scale=1.0: torch.from_numpy(   # noqa: E731
        (scale * rng.randn(*s)).astype(np.float32)).to(tdt)
    q, k, x = mk(n, a, scale=0.6), mk(n, a, scale=0.6), mk(n, d)
    d_res = torch.from_numpy(rng.rand(n, heads).astype(np.float32))
    d_res[:TILE] = 0.0
    ew = torch.from_numpy((rng.rand(pt.windows.in_window.num_slots) + 0.2)
                          .astype(np.float32)).to(tdt).float()
    return q, k, x, d_res, torch.tensor(0.7), ew


# ----------------------------------------------------------------------
# the host side: the slot-to-row table, K5's shared memory and gate, the
# load flags
# ----------------------------------------------------------------------

def test_slot_rows_match_a_direct_construction():
    """gmax reads each slot's row from ``layout.seg`` (int64, contiguous):
    the CSR's rows repeated by their lengths, for the in-window cells, the
    residual and the whole graph's CSR."""
    _, pt = k5_graphs(seed=1)
    wl = pt.windows
    for lay in (wl.in_window, wl.residual, pt.csr):
        want = np.repeat(np.arange(lay.num_rows), np.diff(lay.ptr.numpy()))
        assert lay.seg.dtype == torch.int64 and lay.seg.is_contiguous()
        np.testing.assert_array_equal(lay.seg.numpy(), want)


def test_winatt_gate_admits_every_earlier_shape():
    """K5 keeps nothing in shared memory: its gate is the K projection's,
    and admits every (A, H, D) that the previous gate (a staged f32 q row
    and 2 H floats a warp within 48 KB) admitted."""
    for a, h, d in ((32, 2, 162), (12, 3, 300), (1000, 100, 40),
                    (512, 512, 8), (1536, 1, 4), (64, 64, 1000)):
        cfg = Config(function="transformer", attention_dim=a, heads=h)
        old = fa.kproj_fits(d, a) and 4 * 8 * (a + 2 * h) <= 49_152
        assert not old or wa.winatt_supported(cfg, d), (a, h, d)
        assert wa.winatt_supported(cfg, d) == fa.kproj_fits(d, a)


@pytest.mark.parametrize("lanes", [32, 16, 8])
def test_long_row_segments_match_a_direct_construction(lanes):
    """The rows of more than ``lanes`` cells (K5's 16, the flash kernel's
    32, and 8) go to the segment kernels in segments of 32 cells (the plan
    ``row_split_plan`` makes): those rows, and segments that cover each
    one's cells in order."""
    _, pt = k5_graphs(seed=1)
    ptr = pt.windows.in_window.ptr.numpy()
    plan, nlong, nseg = fa.row_split_plan(ptr, lanes, 32)
    deg = np.diff(ptr)
    rows = [r for r in range(len(deg)) if deg[r] > lanes]
    assert plan[:nlong].tolist() == rows and nlong > 0
    segs = []
    for i, r in enumerate(rows):
        for s0 in range(ptr[r], ptr[r + 1], 32):
            segs.append((i, r, s0, min(s0 + 32, ptr[r + 1])))
    assert nseg == len(segs)
    first, owner = plan[nlong:2 * nlong + 1], plan[2 * nlong + 1:]
    for j, (i, r, sb, se) in enumerate(segs):
        # the kernels' gx_rows::segment
        assert owner[j] == i and plan[owner[j]] == r
        assert ptr[r] + (j - first[i]) * 32 == sb
        assert min(sb + 32, ptr[r + 1]) == se
    assert first[-1] == nseg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_flags_follow_the_head_slices(dtype):
    """16-byte loads where a head slice's bytes and both tensors' starts
    allow them, for scaled_dot only."""
    tdt = getattr(torch, dtype)
    b = tdt.itemsize
    for a, heads in ((32, 2), (12, 3), (8, 1), (48, 3)):
        dk = a // heads
        base = torch.zeros(11, a + 1, dtype=tdt)
        q = torch.zeros(10, a, dtype=tdt)
        kt = torch.zeros(10, a)
        want = int((dk * b) % 16 == 0 and (a * b) % 16 == 0)
        assert fa.score_vec(q, q.clone(), heads, "scaled_dot") == want
        assert fa.score_vec(q, q, heads, "pearson") == 0
        assert fa.score_vec(base[:, 1:], q, heads, "scaled_dot") == 0
        want = int((dk * b) % 16 == 0 and dk % 4 == 0)
        assert fa.score_vec(q, kt, heads, "scaled_dot") == want
        assert fa.score_vec(q, kt, heads, "exp_kernel") == 0
        assert fa.score_vec(q, torch.zeros(10, a + 1)[:, 1:], heads,
                           "scaled_dot") == 0


# ----------------------------------------------------------------------
# the kernels' walks in plain PyTorch
# ----------------------------------------------------------------------

def _butterfly(v):
    """The xor butterfly of width len(v) in f32: every lane's sum (lane 0's
    returned; all lanes hold the same bits)."""
    g = v.shape[0]
    lanes = torch.arange(g)
    o = g // 2
    while o:
        v = v + v[lanes ^ o]
        o //= 2
    return v[0]


def k5_walk(win, q, k, x, d_res, r0, ew, att_type, heads, lanes, ov2=OV2,
            inv2l2=INV2L2):
    """winatt.cu's walk in plain PyTorch. A row of at most ``lanes``
    cells: one e a lane, per head the shift from the cells' max, the
    butterfly of e over the lanes, den; pbar over the heads in order,
    rounded once; each column's f32 sum over the cells in order. A longer
    row: segments of 32 cells, each one's max m_j and butterfly sum of
    exp(s - m_j) per head; the row's shift and d = sum_j sum_j exp(m_j -
    shift) in segment order; each segment's f32 partial sums, added in
    segment order."""
    s_all = wa.winatt_scores_plain(win, q, k, ew, att_type, heads, ov2,
                                   inv2l2)
    ptr = win.ptr.tolist()
    n, d = x.shape
    out = torch.zeros(n, d)
    den = torch.zeros(n, heads)
    clip = lambda v: torch.clamp(v, -70.0, 70.0)  # noqa: E731
    lanes_of = lambda v, g: torch.cat(  # noqa: E731
        [v, torch.zeros(g - v.shape[0])])
    for r in range(n):
        beg, end = ptr[r], ptr[r + 1]
        length = end - beg
        s = s_all[beg:end]
        segs = [(0, length)] if length <= lanes else [
            (b, min(b + 32, length)) for b in range(0, length, 32)]
        pb = torch.zeros(length)
        for h in range(heads):
            top = s[:, h].max() if length else torch.tensor(-float("inf"))
            shift = torch.maximum(top, r0 - 70.0)
            if shift <= fa.NEG / 2:
                shift = torch.tensor(0.0)
            if length <= lanes:
                dd = _butterfly(lanes_of(torch.exp(s[:, h] - shift), lanes))
            else:
                dd = torch.tensor(0.0)
                for b, e_ in segs:
                    m = s[b:e_, h].max()
                    dd = dd + _butterfly(lanes_of(
                        torch.exp(s[b:e_, h] - m), 32)) * torch.exp(m - shift)
            dd = dd + d_res[r, h] * torch.exp(clip(r0 - shift))
            den[r, h] = dd * torch.exp(clip(shift - r0))
            pb = pb + torch.exp(s[:, h] - shift) / (
                dd if dd > 0 else torch.tensor(1.0))
        w = (pb * (1.0 / heads)).to(x.dtype).float()
        row = torch.zeros(d)
        for b, e_ in segs:
            acc = torch.zeros(d)
            for j in range(b, e_):
                acc = acc + w[j] * x[win.idx[beg + j]].float()
            row = row + acc if length > lanes else acc
        out[r] = row
    return out, den


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("att_type,reweight", [
    ("scaled_dot", False), ("scaled_dot", True), ("exp_kernel", True)])
def test_k5_walk_matches_the_plain_version(dtype, att_type, reweight):
    """At the kernel's 16 lanes a row and at 32 (the parent's warp a row),
    on rows of up to W cells; the same bits on rows of at most 16
    cells."""
    _, pt = k5_graphs(seed=2)
    win = pt.windows.in_window
    q, k, x, d_res, r0, ew = k5_inputs(pt, dtype, 3)
    ew = ew if reweight else None
    want_out, want_den = wa.winatt_plain(win, q, k, x, d_res, r0, ew,
                                         att_type, 2, OV2, INV2L2)
    tol = F32 if dtype == "float32" else _bf16_tol(x)
    walks = {}
    assert wa.LANES == 16
    for lanes in (32, wa.LANES):
        out, den = k5_walk(win, q, k, x, d_res, r0, ew, att_type, 2, lanes)
        torch.testing.assert_close(den, want_den, **F32)
        torch.testing.assert_close(out, want_out, **tol)
        walks[lanes] = out, den
    short = torch.from_numpy(np.diff(win.ptr.numpy()) <= 16)
    for a, b in zip(walks[32], walks[16]):
        assert torch.equal(a[short], b[short])


@pytest.mark.parametrize("att_type", ATT_TYPES)
@pytest.mark.parametrize("reweight", [False, True])
def test_gmax_pairs_walk_matches_the_plain_version(att_type, reweight):
    """Each (slot, head) pair p = e H + h scored from q[seg[e]] and
    K[idx[e]] (head slice h), times ew[e]: the max over the pairs in any
    partition is the plain version's, bit for bit."""
    _, pt = k5_graphs(seed=4)
    rng = np.random.RandomState(5)
    lay, heads, a = pt.csr, 2, 8
    n, e = pt.num_nodes, lay.num_slots
    q = torch.from_numpy(rng.randn(n, a).astype(np.float32)).bfloat16()
    kt = torch.from_numpy(rng.randn(n, a).astype(np.float32))
    ew = pt.edge_weight if reweight else None
    want = fa.attention_gmax_plain(lay, q, kt, ew, att_type, heads, OV2,
                                   INV2L2)
    p = torch.arange(e * heads)
    slot, hh = p // heads, p % heads
    dk = a // heads
    cols = hh[:, None] * dk + torch.arange(dk)
    qe = q.float()[lay.seg[slot][:, None], cols][:, None]
    ke = kt[lay.idx.long()[slot][:, None], cols][:, None]
    s = fa.score_math(att_type, qe, ke, OV2, INV2L2)[:, 0]
    if ew is not None:
        s = s * ew[slot]
    threads = 7
    tmax = torch.stack([s[t::threads].max() for t in range(threads)])
    got = tmax.max()
    got = torch.where(got <= fa.NEG / 2, torch.zeros_like(got), got)
    assert torch.equal(got, want)


# ----------------------------------------------------------------------
# the plain versions against graphax's interpreted Pallas kernels
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype,att_type,reweight", [
    ("float32", "scaled_dot", False), ("float32", "scaled_dot", True),
    ("bfloat16", "scaled_dot", False), ("bfloat16", "scaled_dot", True),
    ("float32", "cosine_sim", False), ("float32", "pearson", True),
    ("float32", "exp_kernel", False), ("bfloat16", "exp_kernel", True)])
def test_k5_plain_matches_graphax_k5_interpreted(dtype, att_type, reweight):
    """winatt_plain against `_winatt_call` on rows of 32, 33 and W cells
    and rows with none: out [N, D] and the combined denominators [N, H]."""
    gx, pt = k5_graphs(seed=6)
    gw, win = gx.windows, pt.windows.in_window
    q, k, x, d_res, r0, ew = k5_inputs(pt, dtype, 7)
    n, a = q.shape
    heads, d = 2, x.shape[1]
    t, tile, wn = gw.num_tiles, gw.tile, gw.num_windows
    cells = np.zeros(t * tile * WINDOW, bool)
    cells[win.perm.numpy()] = True
    np.testing.assert_array_equal(np.asarray(gw.dense_mask).reshape(-1) != 0,
                                  cells)
    jdt = jnp.dtype(dtype)
    to_j = lambda v: jnp.asarray(v.float().numpy()).astype(jdt)  # noqa
    pad = t * tile - n
    q_tiles = jnp.pad(to_j(q), ((0, pad), (0, 0))).reshape(t, tile, a)
    dres_t = jnp.transpose(jnp.pad(jnp.asarray(d_res.numpy()),
                                   ((0, pad), (0, 0))).reshape(t, tile, heads),
                           (0, 2, 1))
    scal = jnp.asarray([[OV2, INV2L2, float(r0), 0.0]], jnp.float32)
    dense_w = None
    if reweight:
        flat = np.zeros(t * tile * WINDOW, np.float32)
        flat[win.perm.numpy()] = ew.numpy()
        dense_w = jnp.asarray(flat.reshape(t, tile, WINDOW)).astype(jdt)
    out, dout = _winatt_call(att_type, reweight, heads, a // heads, q_tiles,
                             _slab_pad(to_j(k), wn, WINDOW),
                             _slab_pad(to_j(x), wn, WINDOW), gw.dense_mask,
                             dres_t, scal, gw.tile_win, dense_w)
    want_out = np.asarray(out).reshape(t * tile, d)[:n]
    want_den = np.asarray(jnp.transpose(dout, (0, 2, 1))).reshape(
        t * tile, heads)[:n]
    got_out, got_den = wa.winatt_plain(win, q, k, x, d_res, r0,
                                       ew if reweight else None, att_type,
                                       heads, OV2, INV2L2)
    np.testing.assert_allclose(got_den.numpy(), want_den, **F32)
    tol = F32 if dtype == "float32" else _bf16_tol(x)
    np.testing.assert_allclose(got_out.numpy(), want_out, **tol)
    for r in (40, 41, n - 2, n - 1):
        assert torch.all(got_out[r] == 0)


def _gmax_graphs(seed, weight=None, n=29, e=120, pad=5):
    """The same edges in both packages, tiles of 8 rows and 16-slot blocks
    (padded slots), a padded edge buffer, the last 4 rows without an edge;
    edge weights ``weight`` or random."""
    rng = np.random.RandomState(seed)
    row = rng.randint(0, n - 4, e)
    col = rng.randint(0, n - 4, e)
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    w = (rng.rand(e) + 0.2).astype(np.float32) if weight is None \
        else np.full(e, weight, np.float32)
    gx = GxGraph.from_edges(row, col, n, edge_weight=w,
                            edge_buffer_size=e + pad)
    gx = dataclasses.replace(attach_tiles(gx, tile=8, block_edges=16),
                             strategy="tiled")
    pt = Graph.from_edges(row, col, n, edge_weight=w, edge_buffer_size=e + pad)
    return gx, pt


def _gmax_pair(gx, pt, att_type, reweight, seed, lengthscale=0.8):
    """graphax's `_gmax_call` and the port's plain gmax on the same random
    attention tree (0.3 randn Q/K weights, 0.1 randn biases) and x."""
    base = dict(function="transformer", heads=2, attention_dim=8,
                hidden_dim=5, attention_type=att_type, square_plus=True,
                reweight_attention=reweight)
    gcfg, cfg = GxConfig(**base), Config(**base)
    p = transformer_attention_init(jax.random.PRNGKey(0), gcfg, 5)
    rng = np.random.RandomState(seed)
    for name in ("Q", "K"):
        p[name] = {
            "w": jnp.asarray(rng.randn(*p[name]["w"].shape) * 0.3,
                             jnp.float32),
            "b": jnp.asarray(rng.randn(*p[name]["b"].shape) * 0.1,
                             jnp.float32)}
    if att_type == "exp_kernel":
        p["output_var"] = jnp.asarray(1.3)
        p["lengthscale"] = jnp.asarray(lengthscale)
    att = TransformerAttention(cfg, 5)
    load_graphax_params(att, jax.tree_util.tree_map(np.asarray, p))
    x = rng.randn(gx.num_nodes, 5).astype(np.float32)
    t = gx.tiles
    q_tiles, xg, wk, bk, wb, scal = _prep_inputs(
        gcfg, p, jnp.asarray(x), jnp.asarray(x), gx.edge_weight,
        t.edge_slot, t.slot_mask, t.col, t.num_tiles, t.tile)
    want = _gmax_call(att_type, reweight, 2, q_tiles, xg, wk, bk, wb,
                      t.local_row, t.tile_idx, scal, t.num_tiles, t.tile)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        ops = fa.prep_inputs(cfg, att, pt, xt)
        kt = fa.attention_kproj(xt, ops["wk"], ops["bk"])
        got = fa.attention_gmax_plain(pt.csr, ops["q"], kt, ops["edge_w"],
                                      att_type, 2, ops["ov2"], ops["inv2l2"])
    return float(got), float(want)


@pytest.mark.parametrize("att_type", ATT_TYPES)
@pytest.mark.parametrize("reweight", [False, True])
def test_gmax_plain_matches_graphax_interpreted(att_type, reweight):
    """On 16-slot blocks with padded slots and a padded edge buffer."""
    gx, pt = _gmax_graphs(seed=8)
    assert not np.asarray(gx.tiles.slot_mask).all()     # padded slots
    got, want = _gmax_pair(gx, pt, att_type, reweight, seed=9)
    np.testing.assert_allclose(got, want, **F32)


def test_gmax_of_scores_at_or_below_neg_half_is_zero():
    """exp_kernel's scores are positive (near ov2 with a long lengthscale);
    times edge weights of -1e35 every one lies below NEG/2, so both
    packages give 0."""
    gx, pt = _gmax_graphs(seed=10, weight=-1e35)
    got, want = _gmax_pair(gx, pt, "exp_kernel", True, seed=11,
                           lengthscale=50.0)
    assert got == want == 0.0
