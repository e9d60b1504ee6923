"""The redesigned CSR flash_attention and attention_attspmm, on the CPU.

- The flash kernel's row walk written out in plain PyTorch (`_walk`):
  batches of 32 edges; per head the running max and the sum of the
  weights, rescaled by exp(old - new max) at each batch; rows of more than
  ``split`` edges in segments of ``split`` whose (max, sum) are combined in
  segment order and whose partial sums are added in segment order; the
  weights rnd(e) against the row's final max, c_h = 1 / (H (d_h + 1e-16))
  and sum_e sum_h c_h rnd(x[col] rnd(e_h)) in f32. Held against
  `flash_attention_plain` (f32 1e-5 / 1e-6: the same rounding points, the
  denominators' sums in another order; bf16 one bf16 ulp of a term,
  2^-7 relative and 1e-3 absolute) and against graphax's Pallas flash
  (interpret mode, as tests/test_torch_grand_nl.py runs it) at chip_smoke's
  TOL_FLASH: f32 2e-4 / 2e-5, bf16 2e-2 / 2e-3 (graphax rounds e against
  its running max and rescales); on a graph whose rows have 0, 1, 31, 32,
  33, 64 and 2,000 edges, over the four score types, softmax and
  squareplus, reweight.
- The plain versions' ``out_dtype`` and ``addend``: bit for bit the
  composites the routes ran before (``.to(dtype)``, ``(out_win +
  out).to(dt)``); the windowed and column routes' results bit for bit.
- The host side of the walk: `gather_width` at the widths of every preset
  and on views that start off their vector size, `flash_warps` at every
  preset's heads, `row_split_plan` and its per-layout cache.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from graphax.kernels.dispatch import attach_tiles
from graphax.kernels.pallas_attention import fused_attention_ax_pallas
from graphax.sparse import Graph as GxGraph
from graphax_torch.kernels import attention3 as a3
from graphax_torch.kernels import fused_attention as fa
from graphax_torch.kernels import winatt as wa
from graphax_torch.sparse.graph import Graph
from graphax_torch.sparse.ops import EPS
from graphax_torch.train import BEST_PARAMS, best_config

from test_torch_grand_nl import _cfgs, _np, random_attention

ATT_TYPES = ["scaled_dot", "cosine_sim", "pearson", "exp_kernel"]
DEGREES = [0, 1, 31, 32, 33, 64, 2000]


def _edges(n=200, seed=0):
    """Rows 0-6 with DEGREES edges, the next rows 0-6 edges each, the last
    3 rows none; duplicate edges (columns drawn with replacement)."""
    rng = np.random.RandomState(seed)
    deg = np.r_[DEGREES, rng.randint(0, 7, n - len(DEGREES) - 3), 0, 0, 0]
    row = np.repeat(np.arange(n), deg)
    col = rng.randint(0, n - 3, row.size)
    order = np.lexsort((col, row))
    w = (rng.rand(row.size) + 0.2).astype(np.float32)
    return row[order], col[order], w, n


def _graphs(seed=0):
    row, col, w, n = _edges(seed=seed)
    gx = GxGraph.from_edges(row, col, n, edge_weight=w,
                            edge_buffer_size=row.size + 5)
    gx = dataclasses.replace(attach_tiles(gx, tile=8, block_edges=128),
                             strategy="tiled")
    pt = Graph.from_edges(row, col, n, edge_weight=w,
                          edge_buffer_size=row.size + 5)
    return gx, pt


def _walk(lay, q, x, kt, edge_w, gshift, att_type, heads, ov2=1.0,
          inv2l2=0.5, split=fa.ROW_SPLIT, out_dtype=torch.float32):
    """The kernels' row walk (module docstring) in plain PyTorch."""
    s_all = fa.edge_scores_plain(lay, q, kt, edge_w, att_type, heads, ov2,
                                 inv2l2)
    idx, ptr = lay.idx.long(), lay.ptr.tolist()
    n, d = lay.num_rows, x.shape[1]
    sqp = gshift is not None
    weight = ((lambda z: (z + torch.sqrt(z * z + 4.0)) / 2.0) if sqp
              else torch.exp)

    def stats(sb, se):
        m = den = None
        for b0 in range(sb, se, 32):
            s = s_all[b0:min(b0 + 32, se)]
            m_new = gshift.expand(heads) if sqp else (
                s.amax(0) if m is None else torch.maximum(m, s.amax(0)))
            e = weight(s - m_new).sum(0)
            den = e if den is None else (
                den if sqp else den * torch.exp(m - m_new)) + e
            m = m_new
        return m, den

    def partial(sb, se, m, c):
        acc = torch.zeros(d)
        for b0 in range(sb, se, 32):
            b1 = min(b0 + 32, se)
            w = weight(s_all[b0:b1] - m).to(x.dtype)            # [cnt, H]
            terms = (x[idx[b0:b1]][:, None, :] * w[:, :, None]).float()
            acc += (c[None, :, None] * terms).sum((0, 1))
        return acc

    out = torch.zeros(n, d)
    for r in range(n):
        beg, end = ptr[r], ptr[r + 1]
        if end == beg:
            continue
        segs = [(sb, min(sb + split, end)) for sb in range(beg, end, split)]
        st = [stats(*sg) for sg in segs]
        if sqp:
            m = gshift.expand(heads)
            den = sum(dn for _, dn in st)
        else:
            m = torch.stack([ms for ms, _ in st]).amax(0)
            den = sum(dn * torch.exp(ms - m) for ms, dn in st)
        c = 1.0 / (heads * (den + EPS))
        out[r] = sum(partial(sb, se, m, c) for sb, se in segs)
    return out.to(out_dtype)


def _operands(pt, att_type, sqp, reweight, dtype, seed, d=6):
    gcfg, cfg = _cfgs(hidden_dim=d, attention_type=att_type,
                      square_plus=sqp, reweight_attention=reweight)
    p, att = random_attention(gcfg, cfg, d, seed=seed)
    x = np.random.RandomState(seed + 1).randn(pt.num_nodes, d).astype(
        np.float32)
    xt = torch.from_numpy(x).to(dtype)
    with torch.no_grad():
        ops = fa.prep_inputs(cfg, att, pt, xt)
        kt = fa.attention_kproj(xt, ops["wk"], ops["bk"])
        scal = (att_type, cfg.heads, ops["ov2"], ops["inv2l2"])
        gs = fa.attention_gmax(pt.csr, ops["q"], kt, ops["edge_w"], *scal) \
            if sqp else None
    return gcfg, cfg, p, att, x, xt, ops["q"], kt, ops["edge_w"], gs, scal


def test_degrees():
    _, pt = _graphs()
    deg = np.diff(pt.csr.ptr.numpy())
    assert list(deg[:len(DEGREES)]) == DEGREES and deg.max() == 2000
    assert deg[-3:].sum() == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reweight", [False, True])
@pytest.mark.parametrize("square_plus", [False, True])
@pytest.mark.parametrize("att_type", ATT_TYPES)
def test_walk_matches_plain(att_type, square_plus, reweight, dtype):
    _, pt = _graphs()
    tdt = getattr(torch, dtype)
    *_, xt, q, kt, ew, gs, scal = _operands(pt, att_type, square_plus,
                                            reweight, tdt, seed=3)
    plain = fa.flash_attention_plain(pt.csr, q, xt, kt, ew, gs, *scal)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" \
        else dict(rtol=2.0 ** -7, atol=1e-3)
    # 2,048: the 2,000-edge row in one segment, 63 rescaled batches
    for split in (fa.ROW_SPLIT, 2048, 40, 32):
        walk = _walk(pt.csr, q, xt, kt, ew, gs, *scal, split=split)
        torch.testing.assert_close(walk, plain, **tol)
        assert torch.all(walk[[0, -3, -2, -1]] == 0)


@pytest.mark.parametrize("att_type,square_plus,dtype", [
    (t, s, "float32") for t in ATT_TYPES for s in (False, True)] + [
    ("scaled_dot", False, "bfloat16"), ("pearson", True, "bfloat16")])
def test_walk_matches_pallas(att_type, square_plus, dtype):
    gx, pt = _graphs(seed=1)
    tdt = getattr(torch, dtype)
    gcfg, _, p, _, x, xt, q, kt, ew, gs, scal = _operands(
        pt, att_type, square_plus, True, tdt, seed=5)
    want = _np(fused_attention_ax_pallas(
        gcfg, p, gx.tiles, jnp.asarray(x).astype(getattr(jnp, dtype)),
        edge_weight=gx.edge_weight))
    walk = _walk(pt.csr, q, xt, kt, ew, gs, *scal)
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(walk.numpy(), want, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_out_dtype_and_addend_are_the_composites(dtype):
    """The plain versions and the CPU wrappers with ``out_dtype`` and
    ``addend``: bit for bit the f32 result cast once, and ``(addend +
    f32 result)`` cast once."""
    _, pt = _graphs(seed=2)
    *_, xt, q, kt, ew, gs, scal = _operands(pt, "scaled_dot", True, True,
                                            dtype, seed=7)
    f32 = fa.flash_attention_plain(pt.csr, q, xt, kt, ew, gs, *scal)
    for fn in (fa.flash_attention_plain, fa.flash_attention):
        got = fn(pt.csr, q, xt, kt, ew, gs, *scal, out_dtype=dtype)
        assert got.dtype == dtype and torch.equal(got, f32.to(dtype))
    e, den = fa.attention_norm_plain(pt.csr, q, kt, ew, gs, *scal)
    addend = torch.randn(pt.num_nodes, xt.shape[1],
                         generator=torch.Generator().manual_seed(1))
    for per_col in (False, True):
        f32 = fa.attention_attspmm_plain(pt.csr, e, den, xt, per_col)
        for fn in (fa.attention_attspmm_plain, fa.attention_attspmm):
            got = fn(pt.csr, e, den, xt, per_col, out_dtype=dtype)
            assert got.dtype == dtype and torch.equal(got, f32.to(dtype))
            got = fn(pt.csr, e, den, xt, per_col, addend=addend,
                     out_dtype=dtype)
            assert torch.equal(got, (addend + f32).to(dtype))
    with pytest.raises(ValueError, match="out_dtype"):
        fa.flash_attention(pt.csr, q, xt, kt, ew, gs, *scal,
                           out_dtype=torch.float16)


def _route_graph():
    from graphax_torch.kernels.dispatch import attach_windows

    rng = np.random.RandomState(4)
    n, window = 120, 32
    comm = np.arange(n) // window
    hit = rng.rand(n, n) < np.where(comm[:, None] == comm[None, :], 0.3,
                                    0.03)
    hit[n - 3:] = False
    row, col = np.nonzero(hit)
    g = Graph.from_edges(row, col, n, edge_buffer_size=row.size + 5)
    return attach_windows(g, window=window, tile=8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_routes_unchanged_on_the_cpu(dtype):
    """The windowed route (K5 + the residual's attspmm with K5's half as its
    addend) and the column route (attspmm per column, in x's dtype) give,
    bit for bit, the composites they ran before: each half in f32, then
    ``(out_win + out_res).to(dt)`` and ``attspmm(...).to(dt)``."""
    from graphax_torch.utils.params import linear_apply

    g = _route_graph()
    gcfg, cfg = _cfgs(hidden_dim=16, attention_type="scaled_dot",
                      community_window=32)
    _, att = random_attention(gcfg, cfg, 16, seed=9)
    x = torch.from_numpy(np.random.RandomState(10).randn(
        g.num_nodes, 16).astype(np.float32)).to(dtype)
    with torch.no_grad():
        got = wa.windowed_attention_ax_fast(cfg, att, g, x)
        wl, heads = g.windows, cfg.heads
        q = linear_apply(att.Q, x).to(dtype)
        k = linear_apply(att.K, x).to(dtype)
        q_s = q / torch.sqrt(torch.tensor(cfg.attention_dim // heads,
                                          dtype=torch.float32)).to(dtype)
        kt = fa.attention_kproj(x, att.K.weight.t().to(dtype).contiguous(),
                                att.K.bias.float())
        scal = ("scaled_dot", heads, 0.0, 0.0)
        r0 = fa.attention_gmax_plain(wl.residual, q_s, kt, None, *scal)
        e_res, d_res = fa.attention_norm_plain(wl.residual, q_s, kt, None,
                                               r0, *scal)
        out_win, den = wa.winatt_plain(wl.in_window, q, k, x, d_res, r0,
                                       None, *scal)
        out_res = fa.attention_attspmm_plain(wl.residual, e_res, den, x)
        assert got.dtype == dtype
        assert torch.equal(got, (out_win + out_res).to(dtype))

        ccfg = cfg.replace(attention_norm_idx=1, community_window=0)
        got = a3.colnorm_attention_ax_fast(ccfg, att, g, x)
        p = fa.prep_inputs(ccfg, att, g, x)
        gs = fa.attention_gmax_plain(g.csr, p["q"], kt, None, *scal)
        e, _ = fa.attention_norm_plain(g.csr, p["q"], kt, None, gs, *scal)
        want = fa.attention_attspmm_plain(
            g.csr, e, a3.column_denominators(g.csc, e), x, True).to(dtype)
        assert got.dtype == dtype and torch.equal(got, want)


def _preset_widths():
    return sorted({(best_config(ds).hidden_dim, best_config(ds).heads,
                    best_config(ds).attention_dim) for ds in BEST_PARAMS})


@pytest.mark.parametrize("d,heads,a", _preset_widths())
def test_gather_width_and_warps_at_every_preset(d, heads, a):
    for dt, elem in ((torch.float32, 4), (torch.bfloat16, 2)):
        x = torch.zeros(40, d, dtype=dt)
        assert x.data_ptr() % 16 == 0
        row = d * elem
        want = 8 if row % 8 == 0 else 4 if row % 4 == 0 else elem
        assert fa.gather_width(x) == want
        # a view one row in starts on the row's bytes
        assert fa.gather_width(x[1:]) == want
        # a view one value in: f32 on 4 bytes, bf16 mid-word
        mid = x.reshape(-1)[1:1 + 39 * d].view(39, d)
        assert fa.gather_width(mid) == elem
        add = torch.zeros(41 * d + 1)
        assert fa.gather_width(x, add[1:1 + 40 * d].view(40, d)) \
            == min(want, elem)
        assert fa.gather_width(x, None) == want
    assert fa.flash_warps(a, heads) == 8


def test_gather_width_odd_rows():
    assert fa.gather_width(torch.zeros(10, 7, dtype=torch.bfloat16)) == 2
    assert fa.gather_width(torch.zeros(10, 6, dtype=torch.bfloat16)) == 4
    assert fa.gather_width(torch.zeros(10, 162, dtype=torch.bfloat16)) == 4
    assert fa.gather_width(torch.zeros(10, 162)) == 8
    assert fa.gather_width(torch.zeros(10, 7)) == 4


def test_flash_warps_follow_shared_memory():
    # a + 2h within the flash gate's 48 KB for 8 warps: fewer warps for
    # many heads, never none
    for a, h in ((32, 2), (1024, 256), (768, 384), (1530, 3)):
        w = fa.flash_warps(a, h)
        assert 1 <= w <= 8 and w * 4 * (a + 34 * h) <= fa._SMEM_LIMIT
        assert w == 8 or (w + 1) * 4 * (a + 34 * h) > fa._SMEM_LIMIT


@pytest.mark.parametrize("longer_than,seg", [(256, 256), (32, 256),
                                             (32, 1 << 30), (0, 128)])
def test_row_split_plan(longer_than, seg):
    deg = np.r_[3, 0, 600, 256, 257, 1, 33]
    ptr = np.cumsum(np.r_[0, deg])
    plan, nlong, nseg = fa.row_split_plan(ptr, longer_than, seg)
    rows = np.nonzero(deg > longer_than)[0]
    count = -(-deg[rows] // seg)
    assert (nlong, nseg) == (rows.size, count.sum())
    assert list(plan[:nlong]) == list(rows)
    first = plan[nlong:2 * nlong + 1]
    assert list(first) == list(np.r_[0, np.cumsum(count)])
    owner = plan[2 * nlong + 1:]
    # the segments cover each long row's edges in order, seg at a time
    covered = {r: [] for r in rows}
    for j in range(nseg):
        i = owner[j]
        sb = ptr[rows[i]] + (j - first[i]) * seg
        se = min(sb + seg, ptr[rows[i] + 1])
        assert 0 < se - sb <= seg
        covered[rows[i]].append((sb, se))
    for r, spans in covered.items():
        assert spans[0][0] == ptr[r] and spans[-1][1] == ptr[r + 1]
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    plan, nlong, nseg = fa.row_split_plan(ptr, 600, seg)
    assert (nlong, nseg) == (0, 0) and list(plan) == [0]


def test_row_plan_is_kept_per_layout():
    _, pt = _graphs()
    got = fa._row_plan(pt.csr, 32, 40)
    assert fa._row_plan(pt.csr, 32, 40) is got
    plan, nlong, nseg = got
    want = fa.row_split_plan(pt.csr.ptr.numpy(), 32, 40)
    assert torch.equal(plan, torch.from_numpy(want[0]))
    # rows of 33, 64 and 2000 edges
    assert (nlong, nseg) == want[1:] == (3, 1 + 2 + 50)


def test_squareplus_slack_covers_scores_in_another_order():
    """chip_smoke holds flash's f32 squareplus output to TOL_FLASH plus
    `squareplus_slack`: with scores far below the global shift, a flash
    whose scores are summed in another order (f64, then rounded) and whose
    z * z + 4 is rounded once (a fused multiply-add) misses TOL_FLASH
    against the plain version, and stays within that slack."""
    import chip_smoke as cs

    rng = np.random.RandomState(0)
    n, d, heads = 1500, 24, 2
    deg = rng.geometric(1 / 6, n)
    deg[:3] = (600, 2, 2)
    row = np.repeat(np.arange(n), deg)
    col = rng.randint(0, n, row.size)
    order = np.lexsort((col, row))
    lay = Graph.from_edges(row[order], col[order], n).csr
    gen = torch.Generator().manual_seed(1)
    q, kt = (3.0 * torch.randn(n, 32, generator=gen) for _ in range(2))
    x = torch.randn(n, d, generator=gen)
    scal = ("scaled_dot", heads, 1.0, 0.5)
    gs = fa.attention_gmax_plain(lay, q, kt, None, *scal)
    want = fa.flash_attention_plain(lay, q, x, kt, None, gs, *scal)
    z = fa.edge_scores_plain(lay, q.double(), kt.double(), None,
                             *scal).float() - gs
    ex = (z + torch.sqrt((z.double() * z.double() + 4.0).float())) / 2.0
    den = torch.zeros(n, heads).index_add_(0, lay.seg, ex)
    got = torch.zeros(n, d)
    for h in range(heads):
        got += torch.zeros(n, d).index_add_(
            0, lay.seg, x[lay.idx.long()] * ex[:, h:h + 1]) / (
                den[:, h:h + 1] + EPS)
    got /= heads
    atol, rtol = cs.TOL_FLASH["float32"]
    err = (got - want).abs()
    assert not bool((err <= atol + rtol * want.abs()).all())
    slack = cs.squareplus_slack(lay, q, x, kt, gs, scal)
    assert slack.shape == (n, 1) and bool((slack >= 0).all())
    assert bool((err <= atol + slack + rtol * want.abs()).all())
