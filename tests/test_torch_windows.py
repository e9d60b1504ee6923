"""The windowed (block-dense) layout and its kernels: graphax_torch against
graphax on the same numpy-seeded inputs.

graphax's windowed kernels run as its own tests run them: FORCE on
`pallas_windows` and `pallas_tiled`, Pallas in interpret mode on the CPU.
The port runs the plain PyTorch versions of its kernels (CPU tensors).

Tolerances:
- the partition, node order, layout and reordered dataset are exact;
- f32 products and gradients 1e-5 relative / 1e-6 absolute (f32 sums in
  another order);
- bf16 outputs 2^-7 relative (one bf16 rounding of an f32 sum that differs
  in its last f32 bits may land one ulp, 2^-8, apart) and 1e-2 absolute
  near zero;
- the 3-step windowed Trainer: f32 losses 1e-5 relative, NFE equal,
  parameters 2e-5 absolute (as `tests/test_torch_slice.py`); bf16 losses
  1e-3 relative with equal NFE. Both sides pin in f32 on the windowed
  strategy, so the thresholded edge sets agree; what remains is the order
  of f32 sums before bf16 roundings (2.1e-4 reached on this graph, against
  the 2e-2 the sparse slice needs, where graphax pins in f32 and the port
  in bf16)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax import native as gx_native
from graphax.data import community_reorder as gx_community_reorder
from graphax.data.synthetic import make_sbm_dataset as gx_make_sbm
from graphax.kernels import pallas_tiled, pallas_windows
from graphax.kernels.dispatch import attach_windows as gx_attach_windows
from graphax.kernels.pallas_windows import densify_windows as gx_densify
from graphax.kernels.pallas_windows import spmm_windowed as gx_spmm_windowed
from graphax.kernels.pallas_windows import win_matmul as gx_win_matmul
from graphax.kernels.windows import blocked_window_values
from graphax.kernels.windows import community_order as gx_community_order
from graphax.sparse import Graph as GxGraph
from graphax.sparse.build import build_graph as gx_build_graph
from graphax.train import Config as GxConfig
from graphax.train.loop import Trainer as GxTrainer

from graphax_torch import Trainer, make_sbm_dataset, native
from graphax_torch.data.reorder import community_reorder
from graphax_torch.kernels import windowed_spmm as ws
from graphax_torch.kernels.dispatch import attach_windows
from graphax_torch.kernels.windows import community_order
from graphax_torch.sparse.build import build_graph
from graphax_torch.sparse.graph import Graph
from graphax_torch.train import Config
from graphax_torch.utils.transplant import (
    graphax_to_state_dict, load_graphax_params,
)

BF16_RTOL = 2.0 ** -7


@pytest.fixture(autouse=True)
def _force_windowed(monkeypatch):
    monkeypatch.setattr(pallas_windows, "FORCE", True)
    monkeypatch.setattr(pallas_tiled, "FORCE", True)


# ----------------------------------------------------------------------
# graphs (those of tests/test_pallas_windows.py, plus an SBM)
# ----------------------------------------------------------------------

def _coalesced(row, col, rng):
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    keep = np.ones(len(row), bool)
    keep[1:] = (np.diff(row) != 0) | (np.diff(col) != 0)
    row, col = row[keep], col[keep]
    return row, col, rng.rand(len(row)).astype(np.float32) + 0.1


def clustered_edges(n=96, seed=0, window=16, p_in=0.5, p_out=0.02):
    """SBM with communities the size of one window, ids already ordered."""
    rng = np.random.RandomState(seed)
    comm = np.arange(n) // window
    same = comm[:, None] == comm[None, :]
    p = np.where(same, p_in, p_out)
    hit = rng.rand(n, n) < p
    np.fill_diagonal(hit, False)
    row, col = np.nonzero(hit)
    return n, *_coalesced(row, col, rng)


def random_edges(n=64, e=300, seed=1):
    rng = np.random.RandomState(seed)
    return n, *_coalesced(rng.randint(0, n, e), rng.randint(0, n, e), rng)


def sbm_edges(n=200, seed=2):
    """A shuffled SBM: the partitioner has communities to find."""
    d = make_sbm_dataset(num_nodes=n, num_classes=4, p_in=0.1, p_out=0.01,
                         seed=seed, strategy="sparse", device="cpu")
    e = d.graph.num_edges
    rng = np.random.RandomState(seed)
    return n, d.graph.row[:e].numpy(), d.graph.col[:e].numpy(), \
        rng.rand(e).astype(np.float32) + 0.1


GRAPHS = {"clustered": clustered_edges, "random": random_edges,
          "sbm": sbm_edges}


def both_graphs(maker, tile=8, window=16, pad=5):
    n, row, col, w = maker()
    e = len(row)
    gx = gx_attach_windows(
        GxGraph.from_edges(row, col, n, edge_weight=w,
                           edge_buffer_size=e + pad),
        window=window, tile=tile, block_edges=16, hubs=False)
    pt = attach_windows(
        Graph.from_edges(row, col, n, edge_weight=w, edge_buffer_size=e + pad,
                         device="cpu"), window=window, tile=tile)
    return gx, pt


# ----------------------------------------------------------------------
# partition and layout
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_partition_and_order_equal_graphax(name):
    n, row, col, _ = GRAPHS[name]()
    for parts, cap in ((4, 16), (2, 64), (1, n)):
        got, cut = native.partition_bfs(row, col, n, parts, cap)
        want, want_cut = gx_native.partition_bfs(row, col, n, parts, cap)
        np.testing.assert_array_equal(got, want)
        assert cut == want_cut
    np.testing.assert_array_equal(community_order(row, col, n, window=16),
                                  gx_community_order(row, col, n, window=16))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_layout_equals_graphax_window_tiles(name):
    gx, pt = both_graphs(GRAPHS[name])
    wt, wl = gx.windows, pt.windows
    assert (wl.num_tiles, wl.num_windows, wl.tile, wl.window) == \
        (wt.num_tiles, wt.num_windows, wt.tile, wt.window)
    np.testing.assert_array_equal(wl.tile_win.numpy(), np.asarray(wt.tile_win))
    mask = np.asarray(wt.slot_mask)
    gx_in = np.asarray(wt.edge_slot)[mask]
    assert set(wl.win_edge.tolist()) == set(gx_in.tolist())
    assert len(gx_in) == wl.in_window_edges
    # each in-window edge's cell: graphax's (tile, local row, local column)
    cells = dict(zip(wl.win_edge.tolist(), wl.win_cell.tolist()))
    tiles = np.repeat(np.asarray(wt.tile_idx), mask.shape[1])
    gx_cells = (tiles.reshape(mask.shape)[mask] * wt.tile * wt.window
                + np.asarray(wt.local_row)[mask] * wt.window
                + np.asarray(wt.lcol)[mask])
    assert all(cells[e] == c for e, c in zip(gx_in.tolist(), gx_cells))
    # the residual, as CSR and CSC, is the rest of the edges
    for lay, gx_lay in ((wl.residual, wt.residual),
                        (wl.residual_t, wt.residual_t)):
        gx_res = np.asarray(gx_lay.edge_slot)[np.asarray(gx_lay.slot_mask)]
        assert sorted(lay.perm.tolist()) == sorted(gx_res.tolist())
    assert wl.in_window_edges + wl.residual.num_slots == pt.num_edges
    # the window -> tiles CSR lists every tile under its window
    ptr, tl = wl.win_ptr.numpy(), wl.win_tiles.numpy()
    for w in range(wl.num_windows):
        assert (wl.tile_win.numpy()[tl[ptr[w]:ptr[w + 1]]] == w).all()


def test_build_graph_windowed_strategy_equals_graphax():
    """`build_graph(strategy="windowed")` (window 512, tile 128): the same
    buffers, tile windows and in-window edges as graphax's."""
    n, row, col, _ = sbm_edges(n=700, seed=4)
    gx = gx_build_graph(row, col, n, self_loop_weight=1.0,
                        strategy="windowed")
    pt = build_graph(row, col, n, self_loop_weight=1.0, strategy="windowed",
                     device="cpu")
    assert gx.strategy == pt.strategy == "windowed"
    np.testing.assert_array_equal(pt.col.numpy(), np.asarray(gx.col))
    wt, wl = gx.windows, pt.windows
    assert (wl.tile, wl.window) == (128, 512)
    np.testing.assert_array_equal(wl.tile_win.numpy(), np.asarray(wt.tile_win))
    gx_in = np.asarray(wt.edge_slot)[np.asarray(wt.slot_mask)]
    np.testing.assert_array_equal(np.sort(wl.win_edge.numpy()),
                                  np.sort(gx_in))


def _reorder_both(n, p_in, p_out, seed, frac):
    kw = dict(num_nodes=n, num_classes=4, p_in=p_in, p_out=p_out,
              num_per_class=5, seed=seed)
    gx = gx_community_reorder(gx_make_sbm(**kw), window=16, tile=8,
                              block_edges=16, min_in_window_frac=frac)
    pt = community_reorder(make_sbm_dataset(**kw, strategy="sparse",
                                            device="cpu"),
                           window=16, tile=8, min_in_window_frac=frac)
    return gx, pt


@pytest.mark.parametrize("case", ["windowed", "fallback"])
def test_community_reorder_equals_graphax(case):
    if case == "windowed":
        gx, pt = _reorder_both(96, 0.3, 0.02, 0, 0.35)
        assert gx.graph.strategy == pt.graph.strategy == "windowed"
    else:
        gx, pt = _reorder_both(256, 0.05, 0.05, 1, 0.35)
        assert gx.graph.strategy == "tiled" and pt.graph.strategy == "sparse"
        assert pt.graph.windows is None
    for a, b in ((pt.x, gx.x), (pt.y, gx.y), (pt.train_mask, gx.train_mask),
                 (pt.val_mask, gx.val_mask), (pt.test_mask, gx.test_mask)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    g, gg = pt.graph, gx.graph
    assert g.num_edges == int(gg.num_edges)
    assert g.edge_buffer_size == gg.edge_buffer_size
    for a, b in ((g.row, gg.row), (g.col, gg.col),
                 (g.edge_weight, gg.edge_weight)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ----------------------------------------------------------------------
# kernels (plain versions here) against graphax's interpreted kernels
# ----------------------------------------------------------------------

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _close(got, want, dtype):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=1e-2)


def _inputs(pt, d, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(pt.num_nodes, d).astype(np.float32)
    probe = rng.randn(pt.num_nodes, d).astype(np.float32)
    return x, probe


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["clustered", "random"])
def test_densify_equals_graphax(name, dtype):
    tdt, jdt = DTYPES[dtype]
    gx, pt = both_graphs(GRAPHS[name])
    win, _, _ = blocked_window_values(gx.edge_weight, gx.windows)
    want = gx_densify(win.astype(jdt), gx.windows)
    got = ws.densify(pt.windows, pt.edge_weight, tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["clustered", "random"])
def test_win_matmul_and_its_vjp_equal_graphax(name, dtype):
    tdt, jdt = DTYPES[dtype]
    gx, pt = both_graphs(GRAPHS[name])
    wt, wl = gx.windows, pt.windows
    """The port's product adds an addend (the residual SpMM's result on the
    main path) before its one rounding; graphax adds it after its f32
    product (`spmm_windowed`), which is the same arithmetic."""
    x, probe = _inputs(pt, 5, 3)
    addend = np.random.RandomState(9).randn(pt.num_nodes, 5)
    win, _, _ = blocked_window_values(gx.edge_weight, wt)
    dense_j = gx_densify(win.astype(jdt), wt)
    f = lambda dn, xx, ad: (gx_win_matmul(
        dn, xx, wt.tile_win, num_tiles=wt.num_tiles, tile=wt.tile,
        window=wt.window, num_windows=wt.num_windows, num_nodes=wt.num_nodes)
        + ad.astype(jnp.float32)).astype(jdt)
    want, vjp = jax.vjp(f, dense_j, jnp.asarray(x).astype(jdt),
                        jnp.asarray(addend).astype(jdt))
    want_dd, want_dx, want_da = vjp(jnp.asarray(probe).astype(jdt))

    dense = ws.densify(wl, pt.edge_weight, tdt).requires_grad_(True)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    at = torch.from_numpy(addend).to(tdt).requires_grad_(True)
    got = ws._WinMatmul.apply(dense, xt, wl, at)
    assert got.dtype == tdt and got.shape == (pt.num_nodes, 5)
    got.backward(torch.from_numpy(probe).to(tdt))
    assert dense.grad.dtype == xt.grad.dtype == at.grad.dtype == tdt
    _close(got, want, dtype)
    _close(dense.grad, want_dd, dtype)
    _close(xt.grad, want_dx, dtype)
    _close(at.grad, want_da, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["clustered", "random"])
def test_spmm_windowed_and_its_gradients_equal_graphax(name, dtype):
    """The whole windowed A x as make_fstate assembles it, differentiated
    to the edge values and to x."""
    tdt, jdt = DTYPES[dtype]
    gx, pt = both_graphs(GRAPHS[name])
    wt, wl = gx.windows, pt.windows
    x, probe = _inputs(pt, 6, 4)

    def gx_apply(ev, xx):
        win, res, res_t = blocked_window_values(ev, wt)
        return gx_spmm_windowed(gx_densify(win.astype(jdt), wt), res, res_t,
                                xx, wt)

    want, vjp = jax.vjp(gx_apply, gx.edge_weight,
                        jnp.asarray(x).astype(jdt))
    want_dw, want_dx = vjp(jnp.asarray(probe).astype(jdt))

    w = pt.edge_weight.clone().requires_grad_(True)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    v = w.to(tdt)
    got = ws.spmm_windowed(ws.densify_windows(w, wl, tdt),
                           v[wl.residual.perm], v[wl.residual_t.perm], xt, wl)
    assert got.dtype == tdt
    got.backward(torch.from_numpy(probe).to(tdt))
    _close(got, want, dtype)
    _close(xt.grad, want_dx, dtype)
    e = pt.num_edges
    if dtype == "float32":
        np.testing.assert_allclose(w.grad[:e].numpy(),
                                   np.asarray(want_dw)[:e], rtol=1e-4,
                                   atol=1e-5)
    else:
        # per-edge dot products of D bf16 terms, summed in f32 in another
        # order and rounded to bf16 on both sides
        np.testing.assert_allclose(w.grad[:e].numpy(),
                                   np.asarray(want_dw, np.float32)[:e],
                                   rtol=2 * BF16_RTOL, atol=2e-2)


def test_wrappers_take_cpu_tensors_to_the_plain_versions():
    _, pt = both_graphs(GRAPHS["clustered"])
    wl = pt.windows
    x, probe = _inputs(pt, 7, 5)
    xt, gt = torch.from_numpy(x), torch.from_numpy(probe)
    dense = ws.densify(wl, pt.edge_weight, torch.float32)
    ref = torch.zeros(wl.block_shape).reshape(-1)
    ref[wl.win_cell.long()] = pt.edge_weight[wl.win_edge.long()]
    torch.testing.assert_close(dense, ref.reshape(wl.block_shape))
    # the in-window edges as one dense [N, N] matrix, plus the addend
    n, e_in = pt.num_nodes, wl.win_edge.long()
    a_in = torch.zeros(n, n)
    a_in[pt.row[e_in].long(), pt.col[e_in].long()] = pt.edge_weight[e_in]
    torch.testing.assert_close(ws.win_matmul(wl, dense, xt, gt),
                               a_in @ xt + gt)
    torch.testing.assert_close(ws.win_bwd_dense(wl, gt, xt),
                               ws.win_bwd_dense_plain(wl, gt, xt))
    slab = ws.win_bwd_slab(wl, dense, gt)
    assert slab.shape == xt.shape
    torch.testing.assert_close(slab, ws.win_bwd_slab_plain(wl, dense, gt))
    # windows no tile maps to give zero
    used = set(wl.tile_win.tolist())
    for w in range(wl.num_windows):
        if w not in used:
            assert not slab[w * wl.window:(w + 1) * wl.window].any()


# ----------------------------------------------------------------------
# the slice: a windowed Trainer against graphax's
# ----------------------------------------------------------------------

SLICE = dict(dataset="sbm", block="hard_attention", function="laplacian",
             hidden_dim=16, heads=2, attention_dim=8,
             attention_type="scaled_dot", att_samp_pct=0.8,
             method="dopri5", tol_scale=11353.558848254957, time=3.0,
             adjoint=True, adjoint_method="rk4", adjoint_step_size=1.0,
             batch_norm=True, optimizer="rmsprop", lr=0.005451476553977102,
             decay=0.0, input_dropout=0.0, dropout=0.0, max_nfe=500,
             no_early=True, community_window=64)
SBM = dict(num_nodes=400, num_classes=4, num_features=32, seed=0)


def run_both(dtype: str, steps: int = 3):
    gtr = GxTrainer(GxConfig(**SLICE, dtype=dtype), gx_make_sbm(**SBM))
    gg = gtr.data.graph
    assert gg.strategy == "windowed" and gg.windows.hub is None
    state = gtr.init_state()
    # random Q/K separate the pinned values (see tests/test_torch_slice.py)
    att = state.params["block"]["att_layer"]
    rng = np.random.RandomState(7)
    for name in ("Q", "K"):
        att[name]["w"] = jnp.asarray(0.4 * rng.randn(*att[name]["w"].shape),
                                     jnp.float32)

    tr = Trainer(Config(**SLICE, dtype=dtype),
                 make_sbm_dataset(**SBM, strategy="sparse", device="cpu"),
                 device="cpu")
    g = tr.data.graph
    assert g.strategy == "windowed"
    np.testing.assert_array_equal(g.col.numpy(), np.asarray(gg.col))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    load_graphax_params(tr.model, to_np(state.params),
                        to_np(state.model_state))

    out = {k: [] for k in ("gx_loss", "pt_loss", "gx_nfe", "pt_nfe",
                           "gx_bwd", "pt_bwd")}
    for _ in range(steps):
        state, loss = gtr.train_step(state)
        out["gx_loss"].append(float(loss))
        out["gx_nfe"].append(gtr.fm.get_value())
        out["gx_bwd"].append(gtr.bm.get_value())
        out["pt_loss"].append(tr.train_step())
        out["pt_nfe"].append(tr.fm.get_value())
        out["pt_bwd"].append(tr.bm.get_value())
    out["gx_params"] = graphax_to_state_dict(to_np(state.params),
                                             to_np(state.model_state))
    out["pt_params"] = {k: v.float().numpy()
                        for k, v in tr.model.state_dict().items()}
    return out


def test_windowed_slice_f32_matches_graphax():
    r = run_both("float32")
    np.testing.assert_allclose(r["pt_loss"], r["gx_loss"], rtol=1e-5)
    assert r["pt_nfe"] == r["gx_nfe"] and r["pt_bwd"] == r["gx_bwd"]
    assert r["pt_loss"][-1] < r["pt_loss"][0]
    gx, pt = r["gx_params"], r["pt_params"]
    assert set(gx) == set(pt)
    for k in sorted(gx):
        np.testing.assert_allclose(pt[k], gx[k], rtol=1e-5, atol=2e-5,
                                   err_msg=k)


def test_windowed_slice_bf16_tracks_graphax():
    r = run_both("bfloat16")
    np.testing.assert_allclose(r["pt_loss"], r["gx_loss"], rtol=1e-3)
    assert r["pt_nfe"] == r["gx_nfe"] and r["pt_bwd"] == r["gx_bwd"]
    assert r["pt_loss"][-1] < r["pt_loss"][0]
