"""The redesigned training forward (``attention_fwd_res``: K1 + K2 + K3
with residuals) and row backward (``attention_bwd_rows``: B1 + B2), on the
CPU.

- The host's plans of the long rows' segments (the forward's rows of more
  than 32 edges in segments of ``ROW_SPLIT``, the backward's in segments
  of 32) against a direct numpy construction.
- The kernels' walks in plain PyTorch, in the kernels' order, against the
  plain versions. The forward: a row of at most 32 edges is one batch,
  one edge a lane: per head the max and a butterfly of the 32 lanes' exp(s
  - m), lane j's weight rnd((sum_h e_jh / (den_h or 1)) / H), out's f32
  sums of rnd(x w) in edge order, cast once; a longer row in segments
  through flash's segment kernels (each segment's batches of 32 edges,
  one edge a lane: a running max and the butterfly of the lanes' exp(s -
  max) added to the running sum rescaled to the new max; the row's max
  over the segments and den as the segments' sums rescaled to it in
  segment order, each segment's f32 partials added in segment order).
  The backward: alpha per edge and head; da by ``row_dots``' warp sum of
  each of the U gathered rows (each lane's partial over the vectors of
  the columns it holds, vector v on lane v mod 32); rho by a butterfly; ds and dq in edge order; a longer
  row in segments of 32 (rho's partials added in segment order, then
  each segment's dq partial, added in order). Both in f32 and bf16, on a
  graph with a row of exactly 32 edges, one of 33, one over ``ROW_SPLIT``
  (two forward segments), rows of none and padded slots.
- The plain versions against graphax's interpreted Pallas kernels on that
  graph, the long rows included: ``attention_fwd_res_plain`` against the
  custom VJP's forward (`_forward(..., want_residuals=True)`, K1/K2/K3
  under ``jax.vjp``) and its residuals against `_scores_call` +
  `_norm_call`; ``attention_bwd_rows_plain`` against `_bwd1_call` +
  `_bwd2_call` given the port's residuals, x and Wk (graphax's B2
  projects each gathered row; the port reads the K table ``x Wk + bk``).

Tolerances: f32 values and tables rtol 2e-4 / atol 2e-5 (graphax's
attention tolerance: sums and exp in another order), in either dtype for
the f32 tables and for sums of exact products (scores, shift, den, dq,
rho); the forward's bf16 output, a sum of products rounded to bf16, 2e-2
relative plus two bf16 ulps (2^-6) of the largest x value (a weight
rounded at the margin moves one term by one ulp); ``row_dots`` against a
plain sum of the same partials at the f32 tolerance."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.functions.transformer import transformer_attention_init
from graphax.kernels.dispatch import attach_tiles
from graphax.kernels.pallas_attention import (
    NEG, _bwd1_call, _bwd2_call, _norm_call, _prep_inputs, _scores_call,
    fused_attention_ax_pallas,
)
from graphax.kernels.pallas_tiled import _tile_rows, presence_scale
from graphax.sparse import Graph as GxGraph
from graphax.train import Config as GxConfig

from graphax_torch.functions.transformer import TransformerAttention
from graphax_torch.kernels import fused_attention as fa
from graphax_torch.sparse.graph import Graph
from graphax_torch.sparse.ops import segment_max
from graphax_torch.train import Config
from graphax_torch.utils.transplant import load_graphax_params

F32 = dict(rtol=2e-4, atol=2e-5)
A, HEADS, D = 8, 2, 6
LONG = fa.ROW_SPLIT + 12    # two forward segments, five backward ones


def graphs(seed=0, n=48, e=150, pad=5):
    """The same edges in both packages: row 3 of exactly 32 edges, row 7
    of 33, row 11 of LONG, the rest random (a few duplicates), the last 4
    nodes without an edge either way, a padded edge buffer; tiles of 8
    rows and 16-slot blocks."""
    rng = np.random.RandomState(seed)
    free = np.setdiff1d(np.arange(n - 4), [3, 7, 11])
    row, col = rng.choice(free, e), rng.choice(free, e)
    row[:10], col[:10] = row[10:20], col[10:20]
    parts = [(row, col)]
    for r, cnt in ((3, 32), (7, 33), (11, LONG)):
        parts.append((np.full(cnt, r), rng.choice(n - 4, cnt)))
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
    deg = np.diff(pt.csr.ptr.numpy())
    assert (deg[3], deg[7], deg[11]) == (32, 33, LONG)
    assert not deg[-4:].any()
    return gx, pt


def train_inputs(n, dtype, seed):
    """q [N, A], x and the cotangent g [N, D] in ``dtype``; Wk [D, A] in
    ``dtype`` and bk [A] f32, and the K table x Wk + bk [N, A] f32."""
    rng = np.random.RandomState(seed)
    tdt = getattr(torch, dtype)
    mk = lambda *s, scale=1.0: torch.from_numpy(   # noqa: E731
        (scale * rng.randn(*s)).astype(np.float32))
    q, x, g = mk(n, A, scale=0.6).to(tdt), mk(n, D).to(tdt), mk(n, D).to(tdt)
    wk, bk = mk(D, A, scale=0.4).to(tdt), mk(A, scale=0.1)
    return q, x, g, wk, bk, fa.attention_kproj_plain(x, wk, bk)


def _butterfly(v):
    """The xor butterfly over the last axis (width v.shape[-1]) in f32:
    lane 0's sum (every lane holds the same bits)."""
    lanes = torch.arange(v.shape[-1])
    o = v.shape[-1] // 2
    while o:
        v = v + v[..., lanes ^ o]
        o //= 2
    return v[..., 0]


def _rnd(v, dtype):
    return v.to(dtype).float()


def _zsel(v):
    return torch.where(v > 0, v, torch.ones_like(v))


# ----------------------------------------------------------------------
# the host's plans
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seg", [fa.ROW_SPLIT, fa._BATCH])
def test_segment_plans_match_a_direct_construction(seg):
    """The rows of more than 32 edges go in segments of ``seg`` edges
    (the forward's ROW_SPLIT, the backward's 32): those rows, and segments
    that cover each one's edges in order, as gx_rows::segment reads
    them."""
    _, pt = graphs(seed=1)
    plan, nlong, nseg = fa._row_plan(pt.csr, fa._BATCH, seg)
    plan = plan.numpy()
    ptr = pt.csr.ptr.numpy()
    deg = np.diff(ptr)
    rows = [r for r in range(len(deg)) if deg[r] > fa._BATCH]
    assert plan[:nlong].tolist() == rows
    assert 7 in rows and 11 in rows and 3 not in rows
    segs = [(i, r, s0, min(s0 + seg, ptr[r + 1]))
            for i, r in enumerate(rows)
            for s0 in range(ptr[r], ptr[r + 1], seg)]
    assert nseg == len(segs)
    assert sum(1 for s in segs if s[1] == 11) == -(-LONG // seg)
    first, owner = plan[nlong:2 * nlong + 1], plan[2 * nlong + 1:]
    for j, (i, r, sb, se) in enumerate(segs):
        assert owner[j] == i and plan[owner[j]] == r
        assert ptr[r] + (j - first[i]) * seg == sb
        assert min(sb + seg, ptr[r + 1]) == se
    assert first[-1] == nseg


# ----------------------------------------------------------------------
# the kernels' walks in plain PyTorch
# ----------------------------------------------------------------------

def _scores(lay, q, kt, heads):
    """score()'s order: q's and K's head slices multiplied and summed
    along dk in order, in f32."""
    e, dk = lay.num_slots, q.shape[1] // heads
    qe = q.float()[lay.seg].reshape(e, heads, dk)
    ke = kt[lay.idx.long()].reshape(e, heads, dk)
    s = torch.zeros(e, heads)
    for i in range(dk):
        s = s + qe[..., i] * ke[..., i]
    return s


def fwd_res_walk(lay, q, x, kt, heads, seg=fa.ROW_SPLIT):
    """fwd_res_kernel's walk in plain PyTorch: (out, sc, shift, denom)."""
    n, d = x.shape
    s = _scores(lay, q, kt, heads)
    ptr, idx = lay.ptr.tolist(), lay.idx.long()
    out = torch.zeros(n, d, dtype=x.dtype)
    shift, denom = torch.zeros(n, heads), torch.zeros(n, heads)

    def sums(sb, se, m):
        """f32 sums of rnd(x w) over the edges [sb, se) in order."""
        acc = torch.zeros(d)
        for e in range(sb, se):
            w = torch.zeros(())
            for h in range(heads):
                w = w + torch.exp(s[e, h] - m[h]) / _zsel(den[h])
            w = _rnd(w / heads, x.dtype)
            acc = acc + _rnd(x[idx[e]].float() * w, x.dtype)
        return acc

    def lanes(sb, se, m):
        """Each lane's sum of exp(s - m) over its edges l, l + 32, ... of
        [sb, se), per head [H, 32]."""
        part = torch.zeros(heads, 32)
        for e in range(sb, se):
            part[:, (e - sb) % 32] += torch.exp(s[e] - m)
        return part

    for r in range(n):
        beg, end = ptr[r], ptr[r + 1]
        if end - beg <= 32:
            m = (s[beg:end].max(0).values if end > beg
                 else torch.zeros(heads))
            den = _butterfly(lanes(beg, end, m))
            acc = sums(beg, end, m)
        else:
            cuts = list(range(beg, end, seg))
            ms, dens = [], []
            for sb in cuts:
                # batch_stats: a running max, the sum rescaled to it
                for b0 in range(sb, min(sb + seg, end), 32):
                    b1 = min(b0 + 32, sb + seg, end)
                    bm = s[b0:b1].max(0).values
                    if b0 == sb:
                        m_, d_ = bm, _butterfly(lanes(b0, b1, bm))
                    else:
                        m_new = torch.maximum(m_, bm)
                        d_ = (d_ * torch.exp(m_ - m_new)
                              + _butterfly(lanes(b0, b1, m_new)))
                        m_ = m_new
                ms.append(m_)
                dens.append(d_)
            m = torch.stack(ms).max(0).values
            den = torch.zeros(heads)
            for m_, d_ in zip(ms, dens):
                den = den + d_ * torch.exp(m_ - m)
            acc = torch.zeros(d)
            for sb in cuts:
                acc = acc + sums(sb, min(sb + seg, end), m)
        shift[r], denom[r] = m, den
        out[r] = acc.to(x.dtype)
    return out, s, shift, denom


def _out_tol(dtype, x):
    return F32 if dtype == "float32" else dict(
        rtol=2e-2, atol=2.0 ** -6 * float(x.float().abs().max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fwd_res_walk_matches_the_plain_version(dtype):
    """On rows of none, of 32 edges (one batch), 33 and LONG (segments)."""
    _, pt = graphs(seed=2)
    q, x, _, _, _, kt = train_inputs(pt.num_nodes, dtype, 3)
    want = fa.attention_fwd_res_plain(pt.csr, q, x, kt, HEADS)
    got = fwd_res_walk(pt.csr, q, x, kt, HEADS)
    torch.testing.assert_close(got[0].float(), want[0].float(),
                               **_out_tol(dtype, x))
    for a_, b_ in zip(got[1:], want[1:]):
        torch.testing.assert_close(a_, b_, **F32)
    # the shift is the row's max of its scores however it is walked
    m = segment_max(got[1], pt.csr.seg, pt.num_nodes)
    assert torch.equal(got[2], torch.where(torch.isfinite(m), m,
                                           torch.zeros_like(m)))
    assert not (got[0][-4:].float().any() or got[3][-4:].any())


def row_dots(p, u_rows):
    """``row_dots``' warp sums of the partials p [U, 32] (U = ``u_rows``,
    lane l's partial of row u at p[u, l]): [U] the sum of each row as lane
    e0 + u keeps it."""
    return _butterfly(p[:u_rows])


def bwd_rows_walk(lay, sc, shift, denom, g, x, kt, heads, vec=2, u_rows=2):
    """bwd_rows_kernel's walk in plain PyTorch: (dq, rho). ``vec`` values
    a load vector, ``u_rows`` x rows in flight (the kernel's U)."""
    n, d = x.shape
    a = kt.shape[1]
    dkh = a // heads
    ptr, idx = lay.ptr.tolist(), lay.idx.long()
    lane = (torch.arange(d) // vec) % 32

    def batch(r, sb, cnt):
        """(col, alpha [cnt, H], da [cnt])"""
        col = idx[sb:sb + cnt]
        alpha = torch.exp(sc[sb:sb + cnt] - shift[r]) / _zsel(denom[r])
        part = torch.zeros(cnt, 32).index_add_(
            1, lane, g[r].float() * x.float()[col])
        da = torch.zeros(cnt)
        for e0 in range(0, cnt, u_rows):
            p = torch.zeros(u_rows, 32)
            k = min(u_rows, cnt - e0)
            p[:k] = part[e0:e0 + k]
            da[e0:e0 + k] = row_dots(p, u_rows)[:k]
        return col, alpha, da

    def dq_sums(col, ds):
        out = torch.zeros(a)
        for j in range(len(col)):
            out = out + ds[j].repeat_interleave(dkh) * kt[col[j]]
        return out

    def rho_of(alpha, da):
        t = torch.zeros(heads, 32)
        t[:, :len(da)] = (alpha * (da / heads)[:, None]).t()
        return _butterfly(t)

    dq, rho = torch.zeros(n, a), torch.zeros(n, heads)
    for r in range(n):
        beg, end = ptr[r], ptr[r + 1]
        if end - beg <= 32:
            col, alpha, da = batch(r, beg, end - beg)
            rho[r] = rho_of(alpha, da)
            dq[r] = dq_sums(col, alpha * ((da / heads)[:, None] - rho[r]))
            continue
        items = [batch(r, sb, min(32, end - sb)) for sb in range(beg, end, 32)]
        for col, alpha, da in items:
            rho[r] += rho_of(alpha, da)
        for col, alpha, da in items:
            dq[r] += dq_sums(col, alpha * ((da / heads)[:, None] - rho[r]))
    return dq, rho


@pytest.mark.parametrize("u_rows", [1, 2, 4, 8])
def test_row_dots_hands_each_lane_its_rows_sum(u_rows):
    """The warp sums give each row the sum of its 32 lanes' partials, at
    any power of two of rows in flight."""
    p = torch.from_numpy(np.random.RandomState(u_rows).randn(
        u_rows, 32).astype(np.float32))
    torch.testing.assert_close(row_dots(p, u_rows), p.sum(1), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_rows_walk_matches_the_plain_version(dtype):
    """On rows of none, of 32 edges (one item), 33 and LONG (segments of
    32), on the plain forward's residuals, with loads of two values and
    the kernel's two rows in flight (BR_ROWS), and with four."""
    _, pt = graphs(seed=4)
    q, x, g, _, _, kt = train_inputs(pt.num_nodes, dtype, 5)
    _, sc, shift, denom = fa.attention_fwd_res_plain(pt.csr, q, x, kt, HEADS)
    want = fa.attention_bwd_rows_plain(pt.csr, sc, shift, denom, g, x, kt,
                                       HEADS)
    for u_rows in (2, 4):
        got = bwd_rows_walk(pt.csr, sc, shift, denom, g, x, kt, HEADS,
                            u_rows=u_rows)
        for a_, b_ in zip(got, want):
            torch.testing.assert_close(a_, b_, **F32)
        assert not (got[0][-4:].any() or got[1][-4:].any())
        assert got[0][11].abs().sum() > 0


# ----------------------------------------------------------------------
# the plain versions against graphax's interpreted Pallas kernels
# ----------------------------------------------------------------------

def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


def _attention(seed):
    """graphax's scaled_dot attention tree with random Q/K (0.3 randn
    weights, 0.1 randn biases) and the port's layer loaded from it."""
    base = dict(function="transformer", heads=HEADS, attention_dim=A,
                hidden_dim=D)
    gcfg, cfg = GxConfig(**base), Config(**base)
    p = transformer_attention_init(jax.random.PRNGKey(0), gcfg, D)
    rng = np.random.RandomState(seed)
    for name in ("Q", "K"):
        p[name] = {
            "w": jnp.asarray(rng.randn(*p[name]["w"].shape) * 0.3,
                             jnp.float32),
            "b": jnp.asarray(rng.randn(*p[name]["b"].shape) * 0.1,
                             jnp.float32)}
    att = TransformerAttention(cfg, D)
    load_graphax_params(att, jax.tree_util.tree_map(np.asarray, p))
    return gcfg, cfg, p, att


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fwd_res_plain_matches_graphax_interpreted(dtype):
    """attention_fwd_res_plain against the custom VJP's forward
    (`_forward(..., want_residuals=True)`: K1/K2/K3, under jax.vjp) and
    its residuals against `_scores_call` + `_norm_call` (`:160, 235`):
    out [N, D], scores [E, H] in edge order, shift and denom [N, H]."""
    gx, pt = graphs(seed=6)
    t = gx.tiles
    assert not np.asarray(t.slot_mask).all()
    gcfg, cfg, p, att = _attention(seed=7)
    x = np.random.RandomState(8).randn(gx.num_nodes, D).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    want, _ = jax.vjp(lambda xx: fused_attention_ax_pallas(
        gcfg, p, gx.tiles, xx, edge_weight=gx.edge_weight,
        tiles_t=gx.tiles_t), xj)
    q_tiles, xg, wk, bk, wb, scal = _prep_inputs(
        gcfg, p, xj, xj, gx.edge_weight, t.edge_slot, t.slot_mask, t.col,
        t.num_tiles, t.tile)
    scores, rmax = _scores_call("scaled_dot", False, HEADS, q_tiles, xg, wk,
                                bk, wb, t.local_row, t.tile_idx, scal,
                                t.num_tiles, t.tile)
    present = presence_scale(t.tile_idx, t.num_tiles) > 0
    rmax = jnp.where(present[:, None, None], rmax, NEG)
    w_shift = jnp.where(rmax <= NEG / 2, 0.0, rmax)
    _, w_denom = _norm_call(False, scores, w_shift, t.local_row, t.tile_idx,
                            t.num_tiles, t.tile)
    node = lambda v: _np(jnp.transpose(v, (0, 2, 1)).reshape(   # noqa: E731
        -1, HEADS))[:gx.num_nodes]
    keep = np.asarray(t.slot_mask).reshape(-1)
    w_sc = np.zeros((gx.num_edges, HEADS), np.float32)
    w_sc[np.asarray(t.edge_slot).reshape(-1)[keep]] = _np(
        jnp.moveaxis(scores, 1, 2).reshape(-1, HEADS))[keep]
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    with torch.no_grad():
        ops = fa.prep_inputs(cfg, att, pt, xt)
        kt = fa.attention_kproj(xt, ops["wk"], ops["bk"])
        out, sc, shift, denom = fa.attention_fwd_res_plain(
            pt.csr, ops["q"], xt, kt, HEADS)
    np.testing.assert_allclose(out.float().numpy(), _np(want),
                               **_out_tol(dtype, xt))
    np.testing.assert_allclose(sc.numpy(), w_sc, **F32)
    np.testing.assert_allclose(shift.numpy(), node(w_shift), **F32)
    np.testing.assert_allclose(denom.numpy(), node(w_denom), **F32)
    assert not (out[-4:].float().any() or denom[-4:].any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_rows_plain_matches_graphax_interpreted(dtype):
    """attention_bwd_rows_plain against `_bwd1_call` (`:623`) and
    `_bwd2_call` (`:699`) on the row tiles (16-slot blocks, padded slots),
    given the port's residuals in graphax's tiled layout, g in f32 tiles,
    the gathered x rows and Wk in the state dtype: rho and dq [N, H],
    [N, A]."""
    gx, pt = graphs(seed=9)
    t = gx.tiles
    assert not np.asarray(t.slot_mask).all()
    n, nt, tile = pt.num_nodes, t.num_tiles, t.tile
    q, x, g, wk, bk, kt = train_inputs(n, dtype, 10)
    _, sc, shift, denom = fa.attention_fwd_res_plain(pt.csr, q, x, kt, HEADS)
    jdt = jnp.dtype(dtype)
    to_j = lambda v: jnp.asarray(v.float().numpy()).astype(jdt)  # noqa
    keep = np.asarray(t.slot_mask).reshape(-1)
    slots = np.zeros((keep.size, HEADS), np.float32)
    slots[keep] = sc.numpy()[np.asarray(t.edge_slot).reshape(-1)[keep]]
    b, eb = t.slot_mask.shape
    scores = jnp.asarray(slots.reshape(b, eb, HEADS).transpose(0, 2, 1))
    tiled = lambda v: jnp.transpose(_tile_rows(   # noqa: E731
        jnp.asarray(v.numpy()), nt, tile), (0, 2, 1))
    xg = to_j(x)[t.col]
    _, ah, da, rho_t = _bwd1_call(
        scores, tiled(shift), tiled(denom),
        _tile_rows(jnp.asarray(g.float().numpy()), nt, tile), xg,
        t.local_row, t.tile_idx, nt, tile)
    dq_t = _bwd2_call(HEADS, ah, da, rho_t, xg, to_j(wk),
                      jnp.asarray(bk.numpy())[None, :], t.local_row,
                      t.tile_idx, nt, tile)
    present = (presence_scale(t.tile_idx, nt) > 0)[:, None, None]
    want_rho = _np(jnp.transpose(jnp.where(present, rho_t, 0.0),
                                 (0, 2, 1)).reshape(-1, HEADS))[:n]
    want_dq = _np(jnp.where(present, dq_t, 0.0).reshape(-1, A))[:n]
    dq, rho = fa.attention_bwd_rows_plain(pt.csr, sc, shift, denom, g, x, kt,
                                          HEADS)
    np.testing.assert_allclose(rho.numpy(), want_rho, **F32)
    np.testing.assert_allclose(dq.numpy(), want_dq, **F32)
    assert not (dq[-4:].any() or rho[-4:].any())
    assert np.abs(want_dq[11]).sum() > 0
