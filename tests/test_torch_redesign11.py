"""The redesigned spmm_csr and attention pin, on the CPU.

- `spmm_csr`'s walk loads (`fused_attention.gather_width`) cover a row
  of D = 5, 64, 128 and 162 in f32 and bf16 with aligned loads, and the
  pin's gate follows the K projection that runs (`kproj_supported`).
- The kernels' segment plans replayed in plain PyTorch (`_spmm_walk`,
  `_pin_walk`) on a graph with rows and columns of 0, 1, 31, 32, 33, 129,
  300 and 700 edges, duplicate edges and empty rows: spmm's rows of more
  than ROW_SPLIT edges summed segment by segment, each in edge order, the
  segments in order; the pin's rows of more than 32 edges as segments of
  ROW_SPLIT edges whose per-head running (max, sum) over batches of 32
  are combined in segment order. Held against `spmm_csr_plain` (f32: two
  sums of deg terms in different orders, 2 sqrt(deg) 2^-24 sum|w x|; bf16:
  one bf16 ulp, 2^-7 relative) and `attention_pin_plain` (1e-5 relative,
  1e-7 absolute: the same f32 rounding points, sums in another order).
- On the same graph, the port's `spmm` forward and gradients and its pin
  against graphax's `spmm_pallas` and `attention_edge_means_pallas`,
  interpreted on the CPU as tests/test_torch_kernels.py runs them, at
  that file's tolerances (f32 1e-5 relative, bf16 2^-7; the pin 2e-4
  relative, 2e-5 absolute).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.functions.transformer import transformer_attention_init
from graphax.kernels.dispatch import attach_tiles
from graphax.kernels.pallas_attention import attention_edge_means_pallas
from graphax.kernels.pallas_tiled import blocked_values, spmm_pallas
from graphax.sparse import Graph as GxGraph
from graphax.train import Config as GxConfig
from graphax_torch.functions.transformer import (
    TransformerAttention, attention_edge_means,
)
from graphax_torch.kernels import attention_pin as pin_mod
from graphax_torch.kernels import fused_attention as fa
from graphax_torch.kernels import spmm as spmm_mod
from graphax_torch.sparse.graph import Graph
from graphax_torch.train import Config
from graphax_torch.utils.transplant import load_graphax_params

BF16_RTOL = 2.0 ** -7
ATT_TYPES = ["scaled_dot", "cosine_sim", "pearson", "exp_kernel"]
DEGREES = [0, 1, 31, 32, 33, 129, 300, 700]


def _edges(n=160, seed=0):
    """Rows 0-7 with DEGREES edges, the next rows 0-6 edges each, the last
    3 rows none; columns drawn with replacement (duplicate edges), column
    0 over ROW_SPLIT edges in the transpose."""
    rng = np.random.RandomState(seed)
    deg = np.r_[DEGREES, rng.randint(0, 7, n - len(DEGREES) - 3), 0, 0, 0]
    row = np.repeat(np.arange(n), deg)
    col = np.where(rng.rand(row.size) < 0.15, 0,
                   rng.randint(0, n - 3, row.size))
    order = np.lexsort((col, row))
    w = (rng.rand(row.size) + 0.2).astype(np.float32)
    return row[order], col[order], w, n


def _graphs(seed=0, pad=5):
    row, col, w, n = _edges(seed=seed)
    gx = GxGraph.from_edges(row, col, n, edge_weight=w,
                            edge_buffer_size=row.size + pad)
    gx = dataclasses.replace(attach_tiles(gx, tile=8, block_edges=64),
                             strategy="tiled")
    pt = Graph.from_edges(row, col, n, edge_weight=w,
                          edge_buffer_size=row.size + pad)
    return gx, pt


def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


# ----------------------------------------------------------------------
# the walk's loads and the pin's gate
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype,d,width", [
    (torch.float32, 5, 4), (torch.float32, 64, 8), (torch.float32, 128, 8),
    (torch.float32, 162, 8), (torch.bfloat16, 5, 2),
    (torch.bfloat16, 64, 8), (torch.bfloat16, 128, 8),
    (torch.bfloat16, 162, 4)])
def test_spmm_loads_cover_the_row_aligned(dtype, d, width):
    """spmm_csr's walk loads ``gather_width`` bytes at a time: the widest
    of 8 and 4 bytes that divides a row and x's offset, else one value
    (f32 rows of 20 bytes and bf16 rows of 324 take 4-byte loads, bf16
    rows of 10 one value). Its vectors tile [0, D) exactly, every one on
    its own width; a view one value in takes single values."""
    x = torch.empty(17, d, dtype=dtype)
    vb = fa.gather_width(x)
    assert vb == width
    per = vb // x.element_size()
    starts = np.arange(0, d, per)
    assert starts.size * per == d
    assert all((x.data_ptr() + int(r * d + c) * x.element_size()) % vb == 0
               for r in (0, 1, 16) for c in starts)
    view = torch.empty(18 * d, dtype=dtype)[1:1 + 17 * d].view(17, d)
    assert fa.gather_width(view) == x.element_size()


def test_pin_gate_follows_the_k_projection():
    """The pin runs where its K projection does: bf16 at D 400, A 120 on
    the tensor cores (whose shared memory holds Wk in bf16), and f32 there
    too, on the CUDA-core projection, which streams Wk with x along D. The
    flash, windowed and column routes keep their gate, `kproj_fits`
    (4 (D A + 32 D) bytes within a block's shared memory), which D 400,
    A 120 exceeds. Every preset width runs in both dtypes."""
    assert fa.kproj_supported(torch.bfloat16, 400, 120)
    assert fa.kproj_supported(torch.float32, 400, 120)
    assert fa.kproj_route(torch.float32, 400, 120) == "cuda_core"
    assert not fa.kproj_fits(400, 120)
    for d, a in ((162, 32), (128, 64), (64, 16)):
        for dt in (torch.float32, torch.bfloat16):
            assert fa.kproj_supported(dt, d, a)


# ----------------------------------------------------------------------
# the segment plans replayed
# ----------------------------------------------------------------------

def _spmm_walk(lay, vals, x, split=fa.ROW_SPLIT):
    """spmm_walk and the segment kernels in plain PyTorch: per row, the
    products rounded to x's dtype, summed in f32 in edge order, rows over
    ``split`` edges as segments of ``split`` summed in order; one
    rounding."""
    idx, ptr = lay.idx.long(), lay.ptr.tolist()
    n, d = lay.num_rows, x.shape[1]
    out = torch.zeros(n, d)
    for r in range(n):
        beg, end = ptr[r], ptr[r + 1]
        bounds = [(beg, end)] if end - beg <= split else [
            (sb, min(sb + split, end)) for sb in range(beg, end, split)]
        total = torch.zeros(d)
        for sb, se in bounds:
            part = torch.zeros(d)
            for j in range(sb, se):
                part += (x[idx[j]] * vals[j]).float()
            total += part
        out[r] = total
    return out.to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [5, 6, 64])
def test_spmm_segment_replay_matches_plain(dtype, d):
    _, pt = _graphs(seed=1)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(np.random.RandomState(2).randn(
        pt.num_nodes, d).astype(np.float32)).to(tdt)
    w = pt.edge_weight.to(tdt)
    plan, nlong, nseg = fa.row_split_plan(pt.csr.ptr.numpy(), fa.ROW_SPLIT,
                                          fa.ROW_SPLIT)
    assert nlong == 3 and nseg == 2 + 3 + 6
    for lay, vals in ((pt.csr, w), (pt.csc, spmm_mod.transpose_values(pt, w))):
        got = _spmm_walk(lay, vals, x).float()
        want = spmm_mod.spmm_csr_plain(lay, vals, x, pt.num_nodes).float()
        deg = (lay.ptr[1:] - lay.ptr[:-1]).float()[:, None]
        mag = spmm_mod.spmm_csr_plain(lay, vals.abs(), x.abs(),
                                      pt.num_nodes).float()
        rtol = 1e-5 if dtype == "float32" else BF16_RTOL
        assert bool(((got - want).abs() <= rtol * want.abs()
                     + 2 * deg.sqrt() * 2.0 ** -24 * mag).all())
        assert torch.all(got[-3:] == 0)


def _pin_walk(lay, q, kt, edge_w, att_type, heads, ov2=1.3, inv2l2=0.7,
              split=fa.ROW_SPLIT):
    """pin_kernel and the segment kernels in plain PyTorch: rows of at
    most 32 edges one batch; longer rows as segments of ``split`` edges,
    each with its per-head running (max, sum) over batches of 32 (the sum
    rescaled by exp(old - new max)), combined in segment order; then
    mean_h exp(s - m) / where(d > 0, d, 1) per edge."""
    s_all = fa.edge_scores_plain(lay, q, kt, edge_w, att_type, heads, ov2,
                                 inv2l2)
    ptr = lay.ptr.tolist()
    out = torch.zeros(lay.num_slots)

    def stats(sb, se):
        m = den = None
        for b0 in range(sb, se, 32):
            s = s_all[b0:min(b0 + 32, se)]
            m_new = s.amax(0) if m is None else torch.maximum(m, s.amax(0))
            e = torch.exp(s - m_new).sum(0)
            den = e if den is None else den * torch.exp(m - m_new) + e
            m = m_new
        return m, den

    for r in range(lay.num_rows):
        beg, end = ptr[r], ptr[r + 1]
        if end == beg:
            continue
        bounds = [(beg, end)] if end - beg <= 32 else [
            (sb, min(sb + split, end)) for sb in range(beg, end, split)]
        st = [stats(*b) for b in bounds]
        m = torch.stack([ms for ms, _ in st]).amax(0)
        den = sum(dn * torch.exp(ms - m) for ms, dn in st)
        den = torch.where(den > 0, den, torch.ones_like(den))
        out[beg:end] = (torch.exp(s_all[beg:end] - m) / den).mean(1)
    return out


@pytest.mark.parametrize("att_type", ATT_TYPES)
@pytest.mark.parametrize("reweight", [False, True])
def test_pin_segment_replay_matches_plain(att_type, reweight):
    _, pt = _graphs(seed=3)
    rng = np.random.RandomState(4)
    n, d, a, heads = pt.num_nodes, 10, 8, 2
    q = torch.from_numpy(0.5 * rng.randn(n, a).astype(np.float32))
    x = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    wk = torch.from_numpy(0.3 * rng.randn(d, a).astype(np.float32))
    bk = torch.from_numpy(0.1 * rng.randn(a).astype(np.float32))
    ew = pt.edge_weight if reweight else None
    kt = fa.attention_kproj_plain(x, wk, bk)
    got = _pin_walk(pt.csr, q, kt, ew, att_type, heads)
    want = pin_mod.attention_pin_plain(pt.csr, q, x, wk, bk, ew, att_type,
                                       heads, 1.3, 0.7)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


# ----------------------------------------------------------------------
# against graphax on the hub graph
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_forward_and_gradients_match_pallas_on_hubs(dtype):
    gx, pt = _graphs(seed=5)
    rng = np.random.RandomState(6)
    n = pt.num_nodes
    x = rng.randn(n, 6).astype(np.float32)
    probe = rng.randn(n, 6).astype(np.float32)
    jdt = jnp.dtype(dtype)

    def loss_gx(ev, xx):
        wb = blocked_values(ev, gx.tiles).astype(jdt)
        wb_t = blocked_values(ev, gx.tiles_t).astype(jdt)
        y = spmm_pallas(wb, wb_t, xx, gx.tiles, gx.tiles_t)
        return jnp.sum(y.astype(jnp.float32) * probe), y

    (_, y_gx), (gw, gxx) = jax.value_and_grad(loss_gx, argnums=(0, 1),
                                              has_aux=True)(
        gx.edge_weight, jnp.asarray(x).astype(jdt))
    tdt = getattr(torch, dtype)
    ev = pt.edge_weight.clone().requires_grad_(True)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    wb = ev.to(tdt)
    y = spmm_mod.spmm(pt, wb, spmm_mod.transpose_values(pt, wb), xt)
    (y.float() * torch.from_numpy(probe)).sum().backward()
    rtol = 1e-5 if dtype == "float32" else BF16_RTOL
    np.testing.assert_allclose(y.detach().float().numpy(), _np(y_gx),
                               rtol=rtol, atol=1e-4)
    np.testing.assert_allclose(xt.grad.float().numpy(), _np(gxx), rtol=rtol,
                               atol=1e-4)
    e = pt.num_edges
    np.testing.assert_allclose(ev.grad[:e].numpy(), _np(gw)[:e], rtol=rtol,
                               atol=1e-4)


@pytest.mark.parametrize("att_type", ATT_TYPES)
def test_pin_matches_pallas_on_hubs(att_type):
    gx, pt = _graphs(seed=7)
    d, a = 6, 8
    gcfg = GxConfig(function="transformer", heads=2, attention_dim=a,
                    hidden_dim=d, attention_type=att_type,
                    reweight_attention=True)
    cfg = Config(function="transformer", heads=2, attention_dim=a,
                 hidden_dim=d, attention_type=att_type,
                 reweight_attention=True)
    p = transformer_attention_init(jax.random.PRNGKey(0), gcfg, d)
    rng = np.random.RandomState(8)
    for name in ("Q", "K"):
        p[name] = {"w": jnp.asarray(rng.randn(d, a) * 0.3, jnp.float32),
                   "b": jnp.asarray(rng.randn(a) * 0.1, jnp.float32)}
    if att_type == "exp_kernel":
        p["output_var"] = jnp.asarray(1.3)
        p["lengthscale"] = jnp.asarray(0.8)
    att = TransformerAttention(cfg, d)
    load_graphax_params(att, jax.tree_util.tree_map(np.asarray, p))
    x = rng.randn(pt.num_nodes, d).astype(np.float32)
    want = attention_edge_means_pallas(gcfg, p, gx.tiles, jnp.asarray(x),
                                       int(gx.edge_buffer_size),
                                       edge_weight=gx.edge_weight)
    with torch.no_grad():
        got = attention_edge_means(att, cfg, pt, torch.from_numpy(x),
                                   differentiable=False)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-4, atol=2e-5)
    assert np.all(got[pt.num_edges:].numpy() == 0)
