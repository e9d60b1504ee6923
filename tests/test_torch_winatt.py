"""GRAND-nl on the windowed layout: the port's windowed attention route
(K5's plain version with the three-kernel form on the residual edges), its
plain twin and its gradients against graphax, on the CPU.

graphax runs as its own tests run it: FORCE on `pallas_windows` and
`pallas_tiled`; its XLA `windowed_attention_ax` (the function its K5 tests
pin the kernel to, and its custom VJP replays), and in two cases its
Pallas `windowed_attention_ax_pallas` in interpret mode (slow: tens of
seconds). The port runs the plain PyTorch versions of its kernels. Inputs
come from numpy seeds; weights go through `load_graphax_params`.

The graph: communities the size of a window, a padded edge buffer, a row
tile with no residual edge, rows with no in-window edge and rows with no
edge at all.

Tolerances:
- f32: rtol 2e-4 / atol 2e-5, graphax's own (tests/test_windowed_
  attention.py), for values and gradients; the Trainer's losses 1e-5
  relative with equal NFE, its evaluation logits 1e-4.
- bf16 values: 2e-2 relative / 2e-2 absolute on outputs of size ~1. K5's
  route rounds where graphax's Pallas kernels round (the residual ``e`` in
  f32, the two halves summed in f32 and rounded once), graphax's XLA
  function elsewhere (the residual ``e`` and the combined denominators
  rounded to bf16 before the residual weights); the two halves of one row
  also see different q and k (the residual's k from the bf16 weight in
  f32, q pre-scaled and rounded; K5's k rounded from the f32 weight), as in
  graphax. Seen: 4e-3."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.data.synthetic import make_sbm_dataset as gx_make_sbm
from graphax.functions.transformer import (
    multiply_attention as gx_multiply_attention,
    transformer_attention_apply as gx_attention_apply,
    transformer_attention_init,
)
from graphax.kernels import pallas_tiled, pallas_windows
from graphax.kernels.dispatch import attach_windows as gx_attach_windows
from graphax.kernels.pallas_attention import (
    NEG, SCAL_N, _attspmm_call, _norm_call, _scores_call,
)
from graphax.kernels.pallas_tiled import presence_scale
from graphax.kernels.pallas_windows import densify_windows as gx_densify
from graphax.kernels.pallas_winatt import windowed_attention_ax_pallas
from graphax.kernels.windowed_attention import windowed_attention_ax
from graphax.kernels.windows import blocked_window_values
from graphax.models.gnn import make_gnn
from graphax.sparse import Graph as GxGraph
from graphax.train import Config as GxConfig
from graphax.train.loop import Trainer as GxTrainer
from graphax.utils.params import linear_apply as gx_linear_apply

from graphax_torch import Trainer, make_sbm_dataset
from graphax_torch.functions.transformer import (
    TransformerAttention, attention_ax,
)
from graphax_torch.kernels import fused_attention as fa
from graphax_torch.kernels import winatt as wa
from graphax_torch.kernels.dispatch import attach_windows
from graphax_torch.kernels.windowed_attention import \
    windowed_attention_ax_plain
from graphax_torch.kernels.windowed_spmm import densify_windows
from graphax_torch.sparse.graph import Graph
from graphax_torch.train import Config
from graphax_torch.utils.transplant import load_graphax_params

ATT_TYPES = ["scaled_dot", "cosine_sim", "pearson", "exp_kernel"]
F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
TILE, WINDOW = 8, 16


@pytest.fixture(autouse=True)
def _force_windowed(monkeypatch):
    monkeypatch.setattr(pallas_windows, "FORCE", True)
    monkeypatch.setattr(pallas_tiled, "FORCE", True)


def make_graphs(seed=0, n=72, pad=5):
    """The same windowed graph in both packages: communities of one window,
    tile 0 without a residual edge, rows 20 and 21 without an in-window
    edge, rows 70 and 71 without an edge."""
    rng = np.random.RandomState(seed)
    comm = np.arange(n) // WINDOW
    same = comm[:, None] == comm[None, :]
    hit = rng.rand(n, n) < np.where(same, 0.4, 0.03)
    hit[:TILE] &= same[:TILE]
    hit[20:22] &= ~same[20:22]
    hit[20, n - 8] = hit[21, 3] = True
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
    wl = pt.windows
    assert int(wl.residual.ptr[TILE]) == 0 and wl.residual.num_slots > 0
    ptr = wl.in_window.ptr
    assert int(ptr[22]) == int(ptr[20]) and int(ptr[-1]) == int(ptr[n - 2])
    return gx, pt


def _cfgs(**kw):
    base = dict(function="transformer", heads=2, attention_dim=8,
                hidden_dim=6, attention_type="scaled_dot")
    base.update(kw)
    return GxConfig(**base), Config(**base)


def random_attention(gcfg, cfg, d, seed=1):
    """graphax's attention tree with random Q/K (0.3 randn weights, 0.1
    randn biases), and the port's layer loaded from it."""
    p = transformer_attention_init(jax.random.PRNGKey(0), gcfg, d)
    rng = np.random.RandomState(seed)
    for name in ("Q", "K"):
        p[name] = {
            "w": jnp.asarray(rng.randn(*p[name]["w"].shape) * 0.3,
                             jnp.float32),
            "b": jnp.asarray(rng.randn(*p[name]["b"].shape) * 0.1,
                             jnp.float32)}
    if gcfg.attention_type == "exp_kernel":
        p["output_var"] = jnp.asarray(1.3)
        p["lengthscale"] = jnp.asarray(0.8)
    att = TransformerAttention(cfg, d)
    load_graphax_params(att, jax.tree_util.tree_map(np.asarray, p))
    return p, att


def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


def _inputs(gx, pt, dtype, seed, d=6):
    """x in ``dtype`` for both, and the densified edge weights of each."""
    x = np.random.RandomState(seed).randn(pt.num_nodes, d).astype(np.float32)
    jdt = jnp.dtype(dtype)
    win, _, _ = blocked_window_values(gx.edge_weight, gx.windows)
    gdense = gx_densify(win.astype(jdt), gx.windows)
    tdt = getattr(torch, dtype)
    pdense = densify_windows(pt.edge_weight, pt.windows, tdt)
    return jnp.asarray(x).astype(jdt), gdense, torch.from_numpy(x).to(tdt), \
        pdense


# ----------------------------------------------------------------------
# K5's route and the plain twin against graphax's windowed_attention_ax
# ----------------------------------------------------------------------

@pytest.mark.parametrize("att_type", ATT_TYPES)
@pytest.mark.parametrize("reweight", [False, True])
def test_k5_route_matches_graphax(att_type, reweight):
    gx, pt = make_graphs()
    gcfg, cfg = _cfgs(attention_type=att_type, reweight_attention=reweight)
    p, att = random_attention(gcfg, cfg, 6, seed=2)
    xj, gdense, xt, pdense = _inputs(gx, pt, "float32", 3)
    want = windowed_attention_ax(gcfg, p, gx, xj, dense_weight=gdense)
    with torch.no_grad():
        got = wa.windowed_attention_ax_fast(cfg, att, pt, xt, pdense)
        twin = windowed_attention_ax_plain(cfg, att, pt, xt, pdense)
    assert got.dtype == torch.float32 and got.shape == xt.shape
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    np.testing.assert_allclose(twin.numpy(), _np(want), **F32)
    assert np.all(got[-2:].numpy() == 0)             # rows with no edge


@pytest.mark.parametrize("att_type,reweight", [("scaled_dot", False),
                                               ("pearson", True)])
def test_k5_route_bf16_tracks_graphax(att_type, reweight):
    gx, pt = make_graphs(seed=1)
    gcfg, cfg = _cfgs(attention_type=att_type, reweight_attention=reweight)
    p, att = random_attention(gcfg, cfg, 6, seed=4)
    xj, gdense, xt, pdense = _inputs(gx, pt, "bfloat16", 5)
    want = windowed_attention_ax(gcfg, p, gx, xj, dense_weight=gdense)
    with torch.no_grad():
        got = wa.windowed_attention_ax_fast(cfg, att, pt, xt, pdense)
        twin = windowed_attention_ax_plain(cfg, att, pt, xt, pdense)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), **BF16)
    np.testing.assert_allclose(twin.float().numpy(), _np(want), **BF16)


@pytest.mark.parametrize("att_type,reweight,dtype", [
    ("scaled_dot", False, "float32"), ("cosine_sim", True, "float32"),
    ("exp_kernel", False, "float32"), ("scaled_dot", True, "bfloat16")])
def test_squareplus_twin_matches_graphax(att_type, reweight, dtype):
    """The squareplus route (graphax's XLA function on every backend, the
    plain twin in the port), through the RHS's dispatch."""
    gx, pt = make_graphs(seed=2)
    gcfg, cfg = _cfgs(attention_type=att_type, reweight_attention=reweight,
                      square_plus=True)
    p, att = random_attention(gcfg, cfg, 6, seed=6)
    xj, gdense, xt, pdense = _inputs(gx, pt, dtype, 7)
    want = windowed_attention_ax(gcfg, p, gx, xj, dense_weight=gdense)
    with torch.no_grad():
        got = attention_ax(cfg, att, pt, xt, pdense if reweight else None)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


@pytest.mark.parametrize("dtype,reweight", [("float32", True),
                                            ("bfloat16", False)])
def test_k5_route_matches_graphax_pallas_interpreted(dtype, reweight):
    """graphax's K5 itself (and its residual K1/K2/K3), in interpret
    mode."""
    gx, pt = make_graphs(seed=3, n=40)
    gcfg, cfg = _cfgs(reweight_attention=reweight)
    p, att = random_attention(gcfg, cfg, 6, seed=8)
    xj, gdense, xt, pdense = _inputs(gx, pt, dtype, 9)
    want = windowed_attention_ax_pallas(gcfg, p, gx, xj,
                                        dense_weight=gdense)
    with torch.no_grad():
        got = wa.windowed_attention_ax_fast(cfg, att, pt, xt, pdense)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


# ----------------------------------------------------------------------
# gradients: the route's replay against jax.grad of windowed_attention_ax
# ----------------------------------------------------------------------

def _edge_ax(gcfg, p, gx, x):
    """graphax's per-edge path on the same edges (its own windowed tests'
    oracle, tests/test_windowed_attention.py:55-59)."""
    g = dataclasses.replace(gx, tiles=None, tiles_t=None, windows=None,
                            strategy="edge")
    att, (v, _) = gx_attention_apply(p, gcfg, g, x)
    return gx_multiply_attention(p, gcfg, g, x, att, v)


@pytest.mark.parametrize("att_type,reweight", [
    ("scaled_dot", False), ("cosine_sim", False), ("pearson", False),
    ("exp_kernel", False), ("scaled_dot", True)])
def test_k5_route_gradients_match_graphax(att_type, reweight):
    """The gradients of x, Q, K (exp_kernel's two scalars, the densified
    weights) through the route's replay against jax.grad of
    `windowed_attention_ax`. For cosine_sim and pearson graphax's gradient
    is NaN wherever a residual block has a padded slot (the norm of its
    zero q row, `_unit`, through the one-hot broadcast: ROADMAP Queue 3,
    graphax side); there the port's finite gradients are held to jax.grad
    of graphax's per-edge path at the tolerance graphax's own tests give
    that pair, 5e-4 / 5e-5."""
    gx, pt = make_graphs(seed=4)
    gcfg, cfg = _cfgs(attention_type=att_type, reweight_attention=reweight)
    p, att = random_attention(gcfg, cfg, 6, seed=10)
    xj, gdense, xt, pdense = _inputs(gx, pt, "float32", 11)
    probe = np.random.RandomState(12).randn(pt.num_nodes, 6) \
        .astype(np.float32)

    def loss(pp, xx, dw):
        return jnp.sum(windowed_attention_ax(gcfg, pp, gx, xx,
                                             dense_weight=dw) * probe)

    gp, gxx, gdw = jax.grad(loss, argnums=(0, 1, 2))(p, xj, gdense)
    tol = F32
    if att_type in ("cosine_sim", "pearson"):
        assert not np.isfinite(_np(gxx)).all()          # graphax's NaN
        gp, gxx = jax.grad(lambda pp, xx: jnp.sum(
            _edge_ax(gcfg, pp, gx, xx) * probe), argnums=(0, 1))(p, xj)
        tol = dict(rtol=5e-4, atol=5e-5)
    xt.requires_grad_(True)
    pdense.requires_grad_(True)
    out = attention_ax(cfg, att, pt, xt, pdense if reweight else None)
    (out * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), _np(gxx), **tol)
    for name in ("Q", "K"):
        lin = getattr(att, name)
        np.testing.assert_allclose(lin.weight.grad.numpy(),
                                   _np(gp[name]["w"]).T, err_msg=name, **tol)
        np.testing.assert_allclose(lin.bias.grad.numpy(), _np(gp[name]["b"]),
                                   err_msg=name, **tol)
    if att_type == "exp_kernel":
        for name in ("output_var", "lengthscale"):
            np.testing.assert_allclose(float(getattr(att, name).grad),
                                       float(gp[name]), err_msg=name, **F32)
    if reweight:
        np.testing.assert_allclose(pdense.grad.numpy(), _np(gdw), **F32)
    assert att.V.weight.grad is None and att.Wout.weight.grad is None


def test_route_gradients_stay_finite_where_graphax_overflows():
    """Q scaled 30x spreads the scores so far that some rows sit ~88 or more
    below r0: graphax's `windowed_attention_ax` keeps its value (the port's
    route agrees to f32 rounding) but its gradient overflows (ROADMAP Queue
    3); the port's replay, a row softmax in each row's own frame, stays
    finite and agrees with jax.grad of graphax's per-edge path at the
    tolerance graphax's own tests give that pair."""
    gx, pt = make_graphs(seed=4)
    gcfg, cfg = _cfgs()
    p, att = random_attention(gcfg, cfg, 6, seed=10)
    p["Q"] = {"w": p["Q"]["w"] * 30.0, "b": p["Q"]["b"]}
    with torch.no_grad():
        att.Q.weight.mul_(30.0)
    xj, _, xt, _ = _inputs(gx, pt, "float32", 11)
    want = windowed_attention_ax(gcfg, p, gx, xj)
    _, gxx = jax.grad(lambda pp, xx: jnp.sum(windowed_attention_ax(
        gcfg, pp, gx, xx)), argnums=(0, 1))(p, xj)
    assert not np.isfinite(_np(gxx)).all()
    ge_p, ge_x = jax.grad(lambda pp, xx: jnp.sum(_edge_ax(gcfg, pp, gx, xx)),
                          argnums=(0, 1))(p, xj)
    xt.requires_grad_(True)
    out = attention_ax(cfg, att, pt, xt)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), _np(want), **F32)
    tol = dict(rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(xt.grad.numpy(), _np(ge_x), **tol)
    for name in ("Q", "K"):
        lin = getattr(att, name)
        np.testing.assert_allclose(lin.weight.grad.numpy(),
                                   _np(ge_p[name]["w"]).T, err_msg=name,
                                   **tol)


def test_route_value_and_replay_part_far_below_r0():
    """Q scaled 150x puts rows more than 180 below r0 in every head: there
    K5's e underflows in r0's frame and its zero-select gives the row 0,
    as graphax's `windowed_attention_ax` does, while the replay's twin (a
    row softmax in each row's own frame) gives the row's softmax. So the
    route's value and its gradient are of two functions on those rows
    (ROADMAP Queue 3); on rows less than 80 below r0 in every head they are
    one. The gradient is the twin's, finite."""
    gx, pt = make_graphs(seed=4)
    gcfg, cfg = _cfgs()
    p, att = random_attention(gcfg, cfg, 6, seed=10)
    p["Q"] = {"w": p["Q"]["w"] * 150.0, "b": p["Q"]["b"]}
    with torch.no_grad():
        att.Q.weight.mul_(150.0)
    xj, _, xt, _ = _inputs(gx, pt, "float32", 11)
    want = _np(windowed_attention_ax(gcfg, p, gx, xj))
    e, heads = pt.num_edges, cfg.heads
    with torch.no_grad():
        q = att.Q(xt).reshape(-1, heads, 4)
        k = att.K(xt).reshape(-1, heads, 4)
        s = (q[pt.row[:e]] * k[pt.col[:e]]).sum(-1) / 2.0      # [E, H]
        r0 = float(s[pt.windows.residual.perm].max())
        rmax = torch.full((pt.num_nodes, heads), -np.inf).scatter_reduce(
            0, pt.row[:e, None].expand(-1, heads), s, "amax")
    gap = (r0 - rmax).numpy()
    has = np.diff(pt.csr.ptr.numpy()) > 0
    far, near = has & (gap > 180).all(1), has & (gap < 80).all(1)
    assert far.sum() >= 5 and near.sum() >= 2

    xt.requires_grad_(True)
    out = attention_ax(cfg, att, pt, xt)
    twin = windowed_attention_ax_plain(cfg, att, pt, xt)
    got, tw = out.detach().numpy(), twin.detach().numpy()
    assert not got[far].any() and not want[far].any()
    assert (np.abs(tw[far]).max(1) > 0.1).all()
    both = far | near
    np.testing.assert_allclose(got[both], want[both], **F32)
    np.testing.assert_allclose(got[near], tw[near], **F32)

    probe = torch.from_numpy(
        np.random.RandomState(5).randn(*got.shape).astype(np.float32))
    params = (xt, att.Q.weight, att.K.weight)
    g_route = torch.autograd.grad(out, params, probe)
    g_twin = torch.autograd.grad(twin, params, probe)
    for name, a_, b_ in zip(("x", "Qw", "Kw"), g_route, g_twin):
        assert torch.isfinite(a_).all(), name
        torch.testing.assert_close(a_, b_, **F32, msg=name)


# ----------------------------------------------------------------------
# the residual pieces against graphax's interpreted K1/K2/K3
# ----------------------------------------------------------------------

def _gx_residual(gcfg, p, gx, xj, dt):
    """graphax's residual path of `_make_winatt` (`pallas_winatt.py:
    179-217`): r0, e per edge position, d_res per node."""
    res, wt = gx.windows.residual, gx.windows
    nt, tile, n, h = res.num_tiles, res.tile, gx.num_nodes, gcfg.heads
    dk = gcfg.attention_dim // h
    q = gx_linear_apply(p["Q"], xj).astype(dt)
    q = q / jnp.sqrt(jnp.asarray(dk, jnp.float32)).astype(dt)
    q_tiles = jnp.pad(q, ((0, nt * tile - n), (0, 0))).reshape(nt, tile, -1)
    xg = xj[res.col]
    wk = p["K"]["w"].astype(dt)
    bk = p["K"]["b"].astype(jnp.float32)[None, :]
    wb = jnp.zeros(res.edge_slot.shape, jnp.float32)
    present = presence_scale(res.tile_idx, nt) > 0
    s_res, rmax = _scores_call("scaled_dot", False, h, q_tiles, xg, wk, bk,
                               wb, res.local_row, res.tile_idx,
                               jnp.zeros((1, SCAL_N), jnp.float32), nt, tile)
    rmax = jnp.where(present[:, None, None], rmax, NEG)
    r0 = jnp.max(rmax)
    r0 = jnp.where(r0 <= NEG / 2, 0.0, r0)
    e_res, d_res = _norm_call(False, s_res, jnp.full((nt, h, tile), r0),
                              res.local_row, res.tile_idx, nt, tile)
    d_res = jnp.where(present[:, None, None], d_res, 0.0)
    keep = np.asarray(res.slot_mask).reshape(-1)
    e_edge = np.zeros((gx.num_edges, h), np.float32)
    e_edge[np.asarray(res.edge_slot).reshape(-1)[keep]] = \
        _np(jnp.moveaxis(e_res, 1, 2).reshape(-1, h))[keep]
    node = _np(jnp.transpose(d_res, (0, 2, 1)).reshape(-1, h))[:n]
    return float(r0), e_edge, node, (e_res, xg, present)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_residual_pieces_match_graphax_kernels(dtype):
    """attention_gmax, attention_norm (one shift) and attention_attspmm's
    row form on the residual CSR against graphax's `_scores_call`,
    `_norm_call` and `_attspmm_call` on its residual tiles."""
    gx, pt = make_graphs(seed=5)
    gcfg, cfg = _cfgs()
    p, att = random_attention(gcfg, cfg, 6, seed=13)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    xj, _, xt, _ = _inputs(gx, pt, dtype, 14)
    r0, e_edge, d_node, (e_res, xg, present) = _gx_residual(gcfg, p, gx, xj,
                                                            jdt)
    res = pt.windows.residual
    with torch.no_grad():
        q = (att.Q(xt.float()).to(tdt) / torch.tensor(2.0).to(tdt))
        kt = fa.attention_kproj(xt, att.K.weight.t().to(tdt).contiguous(),
                                att.K.bias.float())
        g = fa.attention_gmax(res, q, kt, None, "scaled_dot", 2)
        e, den = fa.attention_norm(res, q, kt, None, g, "scaled_dot", 2)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(float(g), r0, **F32)
    got_e = np.zeros_like(e_edge)
    got_e[res.perm.numpy()] = e.numpy()
    np.testing.assert_allclose(got_e, e_edge, **tol)
    np.testing.assert_allclose(den.numpy(), d_node, **tol)
    assert np.all(den[:TILE].numpy() == 0)          # the tile without one

    # K3's row form against a denominator table, zeros included
    tile, n = gx.windows.residual.tile, pt.num_nodes
    table = np.random.RandomState(15).rand(n, 2).astype(np.float32) + 0.5
    table[3, 1] = table[40, 0] = 0.0
    tiles_t = gx.windows.residual.num_tiles
    tab_j = jnp.transpose(jnp.pad(jnp.asarray(table),
                                  ((0, tiles_t * tile - n), (0, 0)))
                          .reshape(tiles_t, tile, 2), (0, 2, 1))
    want = _attspmm_call(e_res, tab_j, xg, gx.windows.residual.local_row,
                         gx.windows.residual.tile_idx, tiles_t, tile)
    want = jnp.where(present[:, None, None], want, 0.0) \
        .reshape(tiles_t * tile, -1)[:n]
    with torch.no_grad():
        got = fa.attention_attspmm(res, torch.from_numpy(e_edge)[res.perm],
                                   torch.from_numpy(table), xt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **tol)


def test_k5_plain_rows_without_cells_keep_the_residual_denominator():
    """A row with no in-window cell: out 0 from K5, and its combined
    denominator the residual's (graphax's clip at +-70 both ways)."""
    _, pt = make_graphs(seed=6)
    wl = pt.windows
    n = pt.num_nodes
    gen = torch.Generator().manual_seed(0)
    q, k = torch.randn(n, 8, generator=gen), torch.randn(n, 8, generator=gen)
    x = torch.randn(n, 6, generator=gen)
    d_res = torch.rand(n, 2, generator=gen)
    r0 = torch.tensor(1.5)
    out, den = wa.winatt(wl.in_window, q, k, x, d_res, r0, None,
                         "scaled_dot", 2)
    for r in (20, 21, n - 2, n - 1):
        assert torch.all(out[r] == 0)
        torch.testing.assert_close(den[r], d_res[r], rtol=1e-5, atol=0)


# ----------------------------------------------------------------------
# a windowed GRAND-nl Trainer against graphax's
# ----------------------------------------------------------------------

SLICE = dict(dataset="sbm", block="constant", function="transformer",
             hidden_dim=16, heads=2, attention_dim=8,
             attention_type="scaled_dot", method="dopri5",
             tol_scale=11353.558848254957, time=3.0, adjoint=True,
             adjoint_method="rk4", adjoint_step_size=1.0, batch_norm=True,
             optimizer="rmsprop", lr=0.005451476553977102, decay=0.0,
             input_dropout=0.0, dropout=0.0, max_nfe=500, no_early=True,
             community_window=16, dtype="float32")
SBM = dict(num_nodes=300, num_classes=4, num_features=16, seed=0)


def test_windowed_trainer_matches_graphax(monkeypatch):
    """Three train steps (rk4 adjoint) and an evaluation: f32 losses 1e-5
    relative, forward and backward NFE equal, evaluation logits 1e-4; K5's
    route once per forward, adjoint and evaluation NFE."""
    calls = {}
    for mod, name in ((wa, "winatt"), (fa, "attention_gmax"),
                      (fa, "attention_norm"), (fa, "attention_attspmm")):
        real = getattr(mod, name)

        def counting(*a, _real=real, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, counting)
    gtr = GxTrainer(GxConfig(**SLICE), gx_make_sbm(**SBM))
    gg = gtr.data.graph
    assert gg.strategy == "windowed"
    state = gtr.init_state()
    att = state.params["block"]["func"]["att"]
    rng = np.random.RandomState(7)
    for name in ("Q", "K"):
        att[name]["w"] = jnp.asarray(0.4 * rng.randn(*att[name]["w"].shape),
                                     jnp.float32)

    tr = Trainer(Config(**SLICE), make_sbm_dataset(**SBM, strategy="sparse",
                                                   device="cpu"),
                 device="cpu")
    g = tr.data.graph
    assert g.strategy == "windowed"
    np.testing.assert_array_equal(g.col.numpy(), np.asarray(gg.col))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    load_graphax_params(tr.model, to_np(state.params),
                        to_np(state.model_state))
    for _ in range(3):
        state, gloss = gtr.train_step(state)
        calls.clear()
        loss = tr.train_step()
        nfe, bwd = tr.fm.get_value(), tr.bm.get_value()
        assert np.isfinite(loss)
        np.testing.assert_allclose(loss, float(gloss), rtol=1e-5)
        assert (nfe, bwd) == (gtr.fm.get_value(), gtr.bm.get_value())
        assert calls == {k: nfe + bwd for k in calls} and len(calls) == 4, \
            calls
    model = make_gnn(GxConfig(**SLICE), gtr.data.num_features,
                     gtr.data.num_classes)
    want, _, aux = jax.jit(lambda pp, ms: model.apply(
        pp, ms, gg, gtr.data.x, train=False))(state.params, state.model_state)
    tr.model.eval()
    with torch.no_grad():
        got, out = tr.model(g, tr.data.x, train=False)
    assert out.result.nfe == int(aux["nfe"])
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)
