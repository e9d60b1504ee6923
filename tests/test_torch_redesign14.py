"""The redesigned column backward (B3, ``attention_bwd_cols``) and
``attention_norm`` (K1 + K2 under one shift), on the CPU.

- The host's plans of the long columns' and long rows' segments on the
  CSC and CSR ``ptr`` against a direct numpy construction.
- The kernels' walks in plain PyTorch against the plain versions: B3's
  batch of 32 slots a warp, one slot a lane (alpha and w per slot, dxv's
  f32 sums in slot order, da as each lane's partial over its columns and
  a butterfly of the 32 lanes, dk in slot order), longer columns in
  segments of 32 whose partials are added in segment order; the norm's
  group of 8 lanes a row (the kernel's NM_LANES: each lane's sum over its
  slots of the row's batches, a butterfly of width 8 per head), longer
  rows in segments. The 8-lane den equals the parent's warp of 32 lanes
  (lane l summing slots l, l + 32, ...; a butterfly of 32) bit for bit on
  rows of at most 16 slots.
- ``attention_bwd_cols_plain`` against graphax's B3 (`_bwd3_call`) in
  interpret mode on a column-tiled layout with padded slots, a column of
  exactly the cutover (32 slots), one of 33 and columns of none.
- ``attention_norm_plain`` against graphax's `_scores_call` +
  `_norm_call` under one shift, in interpret mode, for every score type,
  with and without reweight, softmax and squareplus, on a row-tiled
  layout with a row of exactly the norm's cutover (32 slots), one of 33,
  padded slots and rows of none.

Tolerances: f32 values rtol 2e-4 / atol 2e-5 (graphax's attention
tolerance: sums and exp in another order), in either dtype for f32
tables and sums of exact products (dk, e, den); dxv in bf16, a sum of
products rounded to bf16, 2e-2 relative plus two bf16 ulps (2^-6) of the
largest cotangent value (a weight rounded at the margin moves one term by
one ulp); the 8-lane and 32-lane den on rows of at most 16 slots
exactly."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.functions.transformer import transformer_attention_init
from graphax.kernels.dispatch import attach_tiles
from graphax.kernels.pallas_attention import (
    NEG, _bwd3_call, _norm_call, _prep_inputs, _scores_call,
)
from graphax.kernels.pallas_tiled import _tile_rows, presence_scale
from graphax.sparse import Graph as GxGraph
from graphax.train import Config as GxConfig

from graphax_torch.functions.transformer import TransformerAttention
from graphax_torch.kernels import fused_attention as fa
from graphax_torch.sparse.graph import Graph
from graphax_torch.train import Config
from graphax_torch.utils.transplant import load_graphax_params

ATT_TYPES = ["scaled_dot", "cosine_sim", "pearson", "exp_kernel"]
F32 = dict(rtol=2e-4, atol=2e-5)
A, HEADS, D = 8, 2, 5


def graphs(seed=0, n=48, e=150, pad=5):
    """The same edges in both packages: column 5 of exactly 32 slots,
    column 9 of 33, row 3 of exactly 32, row 7 of 33, the rest random (a
    few duplicates), the last 4 nodes without an edge either way, a padded
    edge buffer; tiles of 8 rows and 16-slot blocks."""
    rng = np.random.RandomState(seed)
    free = np.setdiff1d(np.arange(n - 4), [3, 7, 5, 9])
    row, col = rng.choice(free, e), rng.choice(free, e)
    row[:10], col[:10] = row[10:20], col[10:20]
    parts = [(row, col)]
    for c, cnt in ((5, 32), (9, 33)):
        parts.append((rng.choice(free, cnt), np.full(cnt, c)))
    for r, cnt in ((3, 32), (7, 33)):
        parts.append((np.full(cnt, r), rng.choice(free, cnt)))
    row = np.concatenate([p[0] for p in parts])
    col = np.concatenate([p[1] for p in parts])
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    w = (rng.rand(row.size) + 0.2).astype(np.float32)
    size = row.size + pad
    gx = GxGraph.from_edges(row, col, n, edge_weight=w, edge_buffer_size=size)
    gx = dataclasses.replace(attach_tiles(gx, tile=8, block_edges=16),
                             strategy="tiled")
    pt = Graph.from_edges(row, col, n, edge_weight=w, edge_buffer_size=size)
    cdeg = np.diff(pt.csc.ptr.numpy())
    rdeg = np.diff(pt.csr.ptr.numpy())
    assert (cdeg[5], cdeg[9], rdeg[3], rdeg[7]) == (32, 33, 32, 33)
    assert not (cdeg[-4:].any() or rdeg[-4:].any())
    return gx, pt


def b3_inputs(n, dtype, seed):
    """q [N, A], g and x [N, D] in ``dtype``; the K table [N, A] f32;
    shift, denom (a few zeros: the zero-select) and rho [N, H] f32."""
    rng = np.random.RandomState(seed)
    tdt = getattr(torch, dtype)
    mk = lambda *s, scale=1.0: torch.from_numpy(   # noqa: E731
        (scale * rng.randn(*s)).astype(np.float32))
    q, g, x = mk(n, A, scale=0.6).to(tdt), mk(n, D).to(tdt), mk(n, D).to(tdt)
    kt = mk(n, A, scale=0.6)
    shift = mk(n, HEADS, scale=0.5)
    denom = torch.from_numpy((rng.rand(n, HEADS) * 3 + 0.5).astype(
        np.float32))
    denom[::7] = 0.0
    return q, g, x, kt, shift, denom, mk(n, HEADS, scale=0.3)


def _butterfly(v):
    """The xor butterfly over the last axis (width v.shape[-1]) in f32:
    lane 0's sum (every lane holds the same bits)."""
    lanes = torch.arange(v.shape[-1])
    o = v.shape[-1] // 2
    while o:
        v = v + v[..., lanes ^ o]
        o //= 2
    return v[..., 0]


# ----------------------------------------------------------------------
# the host's plans
# ----------------------------------------------------------------------

@pytest.mark.parametrize("which", ["csc", "csr"])
def test_segment_plans_match_a_direct_construction(which):
    """B3's columns of more than 32 slots (the CSC) and the norm's rows of
    more than NORM_CUT (the CSR) go in segments of 32 and NORM_SEG slots:
    those columns (rows), and segments that cover each one's slots in
    order, as the kernels' gx_rows::segment reads them."""
    _, pt = graphs(seed=1)
    lay = getattr(pt, which)
    cut, seg = ((fa._BATCH, fa._BATCH) if which == "csc"
                else (fa.NORM_CUT, fa.NORM_SEG))
    plan, nlong, nseg = (t.cpu().numpy() if torch.is_tensor(t) else t
                         for t in fa._row_plan(lay, cut, seg))
    ptr = lay.ptr.numpy()
    deg = np.diff(ptr)
    rows = [r for r in range(len(deg)) if deg[r] > cut]
    assert plan[:nlong].tolist() == rows
    assert (9 if which == "csc" else 7) in rows
    assert (5 if which == "csc" else 3) not in rows
    segs = [(i, r, s0, min(s0 + seg, ptr[r + 1]))
            for i, r in enumerate(rows) for s0 in range(ptr[r], ptr[r + 1],
                                                        seg)]
    assert nseg == len(segs)
    first, owner = plan[nlong:2 * nlong + 1], plan[2 * nlong + 1:]
    for j, (i, r, sb, se) in enumerate(segs):
        assert owner[j] == i and plan[owner[j]] == r
        assert ptr[r] + (j - first[i]) * seg == sb
        assert min(sb + seg, ptr[r + 1]) == se
    assert first[-1] == nseg


# ----------------------------------------------------------------------
# the kernels' walks in plain PyTorch
# ----------------------------------------------------------------------

def b3_walk(lay, q, g, x, kt, shift, denom, rho, heads, vec=2):
    """bwd_cols_kernel's walk in plain PyTorch. An item is a column of at
    most 32 slots or a segment of 32 slots of a longer one, lane j holding
    slot j: alpha per head and w = rnd(mean_h alpha); dxv's f32 sums of
    rnd(g[r] w) in slot order; da as each lane's partial over the columns
    it holds (vectors of ``vec`` values, vector v on lane v mod 32) and a
    butterfly of the 32 lanes; ds = alpha (da / H - rho[r]); dk = sum
    ds_h q[r]_h in slot order. A long column's items are added in
    segment order."""
    n, d = x.shape
    a = kt.shape[1]
    dkh = a // heads
    ptr, idx = lay.ptr.tolist(), lay.idx.long()
    lane = (torch.arange(d) // vec) % 32

    def item(c, sb, se):
        r = idx[sb:se]
        cnt = se - sb
        qe = q.float()[r].reshape(cnt, heads, dkh)
        s = fa.score_math("scaled_dot", qe,
                          kt[c].reshape(1, heads, dkh).expand_as(qe))
        dn = denom[r]
        alpha = torch.exp(s - shift[r]) / torch.where(dn > 0, dn, 1.0)
        wsum = alpha[:, 0]
        for h in range(1, heads):
            wsum = wsum + alpha[:, h]
        w = (wsum / heads).to(g.dtype)
        dxv = torch.zeros(d)
        for j in range(cnt):
            dxv = dxv + (g[r[j]] * w[j]).float()
        part = torch.zeros(cnt, 32).index_add_(
            1, lane, g.float()[r] * x.float()[c])
        da = _butterfly(part)
        ds = alpha * (da[:, None] / heads - rho[r])
        dk = torch.zeros(a)
        for j in range(cnt):
            dk = dk + ds[j].repeat_interleave(dkh) * qe[j].reshape(a)
        return dk, dxv

    dk, dxv = torch.zeros(n, a), torch.zeros(n, d)
    for c in range(n):
        beg, end = ptr[c], ptr[c + 1]
        if end - beg <= 32:
            dk[c], dxv[c] = item(c, beg, end)
            continue
        for s0 in range(beg, end, 32):
            pk, pv = item(c, s0, min(s0 + 32, end))
            dk[c] += pk
            dxv[c] += pv
    return dk, dxv


def _dxv_tol(dtype, g):
    return F32 if dtype == "float32" else dict(
        rtol=2e-2, atol=2.0 ** -6 * float(g.float().abs().max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b3_walk_matches_the_plain_version(dtype):
    """On columns of none, of 32 slots (one item) and of 33 (two
    segments)."""
    _, pt = graphs(seed=2)
    q, g, x, kt, shift, denom, rho = b3_inputs(pt.num_nodes, dtype, 3)
    want = fa.attention_bwd_cols_plain(pt.csc, q, g, x, kt, shift, denom,
                                       rho, HEADS)
    got = b3_walk(pt.csc, q, g, x, kt, shift, denom, rho, HEADS)
    torch.testing.assert_close(got[0], want[0], **F32)
    torch.testing.assert_close(got[1], want[1], **_dxv_tol(dtype, g))
    assert not (got[0][-4:].any() or got[1][-4:].any())


def norm_walk(lay, s, gshift, heads, lanes, cut, seg, square_plus=False):
    """norm_kernel's walk in plain PyTorch from the scores ``s`` [E, H]: e
    = weight(s - g); an item (a row of at most ``cut`` slots, or a segment
    of ``seg`` slots of a longer one) walked by ``lanes`` lanes, lane l
    summing e over its slots l, l + lanes, ... in order, then per head a
    butterfly of width ``lanes``; a long row's items added in segment
    order. ``lanes=32, cut=None`` is the parent's warp a row."""
    z = s - gshift
    e = (z + torch.sqrt(z * z + 4.0)) / 2.0 if square_plus else torch.exp(z)
    ptr = lay.ptr.tolist()

    def item(sb, se):
        part = torch.zeros(heads, lanes)
        for k in range(sb, se):
            part[:, (k - sb) % lanes] += e[k]
        return _butterfly(part)

    den = torch.zeros(lay.num_rows, heads)
    for r in range(lay.num_rows):
        beg, end = ptr[r], ptr[r + 1]
        if cut is None or end - beg <= cut:
            den[r] = item(beg, end)
            continue
        for s0 in range(beg, end, seg):
            den[r] += item(s0, min(s0 + seg, end))
    return e, den


@pytest.mark.parametrize("square_plus", [False, True])
@pytest.mark.parametrize("att_type", ["scaled_dot", "exp_kernel"])
def test_norm_walk_matches_the_plain_version(att_type, square_plus):
    """The 8-lane walk (the kernel's NM_LANES) with the kernel's cutover
    and segments against the plain version, and its den equal to the
    parent's 32-lane den on the rows of at most 16 slots (two batches of
    8: the pairs the parent's butterfly adds at its step of 8)."""
    _, pt = graphs(seed=4)
    rng = np.random.RandomState(5)
    n = pt.num_nodes
    q = torch.from_numpy(rng.randn(n, A).astype(np.float32)).bfloat16()
    kt = torch.from_numpy(rng.randn(n, A).astype(np.float32))
    ew = pt.edge_weight
    scal = (att_type, HEADS, 1.3, 0.7)
    gs = fa.attention_gmax_plain(pt.csr, q, kt, ew, *scal)
    want_e, want_den = fa.attention_norm_plain(pt.csr, q, kt, ew, gs, *scal,
                                               square_plus=square_plus)
    s = fa.edge_scores_plain(pt.csr, q, kt, ew, *scal)
    e, den = norm_walk(pt.csr, s, gs, HEADS, 8, fa.NORM_CUT, fa.NORM_SEG,
                       square_plus)
    assert torch.equal(e, want_e)
    torch.testing.assert_close(den, want_den, **F32)
    _, parent = norm_walk(pt.csr, s, gs, HEADS, 32, None, None, square_plus)
    short = torch.from_numpy(np.diff(pt.csr.ptr.numpy()) <= 16)
    deg = np.diff(pt.csr.ptr.numpy())
    assert short.sum() > 20 and (deg > 8).sum() >= 4 and (~short).sum() >= 2
    assert torch.equal(den[short], parent[short])


# ----------------------------------------------------------------------
# the plain versions against graphax's interpreted Pallas kernels
# ----------------------------------------------------------------------

def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b3_plain_matches_graphax_interpreted(dtype):
    """attention_bwd_cols_plain against `_bwd3_call` (`:794`) on the
    column tiles (16-slot blocks, padded slots), given the f32 K table as
    its k tiles (the port's kernel reads the same table) and the per-row
    tables gathered at each slot's row, as graphax's backward gathers
    them (`:1232-1240`): dk [N, A] and dxv [N, D]."""
    gx, pt = graphs(seed=6)
    tt = gx.tiles_t
    assert not np.asarray(tt.slot_mask).all()
    n = pt.num_nodes
    q, g, x, kt, shift, denom, rho = b3_inputs(n, dtype, 7)
    jdt = jnp.dtype(dtype)
    to_j = lambda v: jnp.asarray(v.float().numpy()).astype(jdt)  # noqa
    rows = tt.col
    tab = lambda v: jnp.asarray(v.numpy())[rows]  # noqa: E731
    dk_t, dxv_t = _bwd3_call(
        HEADS, to_j(q)[rows], to_j(g)[rows],
        _tile_rows(jnp.asarray(kt.numpy()), tt.num_tiles, tt.tile),
        _tile_rows(to_j(x), tt.num_tiles, tt.tile), tab(shift), tab(denom),
        tab(rho), tt.local_row, tt.tile_idx, tt.num_tiles, tt.tile)
    present = (presence_scale(tt.tile_idx, tt.num_tiles) > 0)[:, None, None]
    want_dk = _np(jnp.where(present, dk_t, 0.0).reshape(-1, A))[:n]
    want_dxv = _np(jnp.where(present, dxv_t, 0.0).reshape(-1, D))[:n]
    dk, dxv = fa.attention_bwd_cols_plain(pt.csc, q, g, x, kt, shift,
                                          denom, rho, HEADS)
    np.testing.assert_allclose(dk.numpy(), want_dk, **F32)
    np.testing.assert_allclose(dxv.numpy(), want_dxv, **_dxv_tol(dtype, g))
    assert not (dk[-4:].any() or dxv[-4:].any())


def _attention(att_type, reweight, seed):
    """graphax's attention tree with random Q/K (0.3 randn weights, 0.1
    randn biases; exp_kernel's output_var 1.3, lengthscale 0.8) and the
    port's layer loaded from it."""
    base = dict(function="transformer", heads=HEADS, attention_dim=A,
                hidden_dim=D, attention_type=att_type,
                reweight_attention=reweight)
    gcfg, cfg = GxConfig(**base), Config(**base)
    p = transformer_attention_init(jax.random.PRNGKey(0), gcfg, D)
    rng = np.random.RandomState(seed)
    for name in ("Q", "K"):
        p[name] = {
            "w": jnp.asarray(rng.randn(*p[name]["w"].shape) * 0.3,
                             jnp.float32),
            "b": jnp.asarray(rng.randn(*p[name]["b"].shape) * 0.1,
                             jnp.float32)}
    if att_type == "exp_kernel":
        p["output_var"] = jnp.asarray(1.3)
        p["lengthscale"] = jnp.asarray(0.8)
    att = TransformerAttention(cfg, D)
    load_graphax_params(att, jax.tree_util.tree_map(np.asarray, p))
    return gcfg, cfg, p, att


@pytest.mark.parametrize("att_type", ATT_TYPES)
@pytest.mark.parametrize("reweight", [False, True])
def test_norm_plain_matches_graphax_interpreted(att_type, reweight):
    """attention_norm_plain under the global max against `_scores_call`
    and `_norm_call` with that one shift for every row (`:160, 235`),
    softmax and squareplus: e in edge order [E, H] and the row sums
    [N, H]."""
    gx, pt = graphs(seed=8)
    t = gx.tiles
    assert not np.asarray(t.slot_mask).all()
    gcfg, cfg, p, att = _attention(att_type, reweight, seed=9)
    x = np.random.RandomState(10).randn(gx.num_nodes, D).astype(np.float32)
    xj = jnp.asarray(x)
    q_tiles, xg, wk, bk, wb, scal = _prep_inputs(
        gcfg, p, xj, xj, gx.edge_weight, t.edge_slot, t.slot_mask, t.col,
        t.num_tiles, t.tile)
    scores, rmax = _scores_call(att_type, reweight, HEADS, q_tiles, xg, wk,
                                bk, wb, t.local_row, t.tile_idx, scal,
                                t.num_tiles, t.tile)
    present = presence_scale(t.tile_idx, t.num_tiles) > 0
    gmax = jnp.max(jnp.where(present[:, None, None], rmax, NEG))
    gmax = jnp.where(gmax <= NEG / 2, 0.0, gmax)
    keep = np.asarray(t.slot_mask).reshape(-1)
    slot = np.asarray(t.edge_slot).reshape(-1)[keep]
    xt = torch.from_numpy(x)
    with torch.no_grad():
        ops = fa.prep_inputs(cfg, att, pt, xt)
        sc_p = (att_type, HEADS, ops["ov2"], ops["inv2l2"])
        kt = fa.attention_kproj(xt, ops["wk"], ops["bk"])
        g = fa.attention_gmax_plain(pt.csr, ops["q"], kt, ops["edge_w"],
                                    *sc_p)
    np.testing.assert_allclose(float(g), float(gmax), **F32)
    for square_plus in (False, True):
        e, dn = _norm_call(square_plus, scores, jnp.full_like(rmax, gmax),
                           t.local_row, t.tile_idx, t.num_tiles, t.tile)
        want_e = np.zeros((pt.num_edges, HEADS), np.float32)
        want_e[slot] = _np(jnp.moveaxis(e, 1, 2).reshape(-1, HEADS))[keep]
        want_den = _np(jnp.transpose(jnp.where(
            present[:, None, None], dn, 0.0), (0, 2, 1)).reshape(
                -1, HEADS))[:gx.num_nodes]
        got_e, got_den = fa.attention_norm_plain(
            pt.csr, ops["q"], kt, ops["edge_w"], g, *sc_p,
            square_plus=square_plus)
        np.testing.assert_allclose(got_e.numpy(), want_e, **F32)
        np.testing.assert_allclose(got_den.numpy(), want_den, **F32)
        assert not got_den[-4:].any()
