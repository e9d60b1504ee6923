"""The f32 bodies of win_matmul, win_bwd_dense and win_bwd_slab on their
FMA core, on the CPU.

- The core's walk in plain PyTorch: the CTAs' decomposition (128 output
  rows by 192 columns of D for win_matmul and win_bwd_slab, by 128 slab
  rows for win_bwd_dense), K in steps of 32 k (16 in win_bwd_dense)
  bounded by the real depth (W, D, each tile's rows in the window ->
  tiles CSR's order), each
  output one running f32 sum from +0, one fmaf a k in K order (modelled
  as tests/test_torch_redesign12.py models the K projection: the exact
  product added in f64 and rounded once), win_matmul's addend added last
  with one rounding, stores guarded by N. Against `win_matmul_plain`,
  `win_bwd_dense_plain` and `win_bwd_slab_plain` at TOL_WIN (1e-5
  relative, 1e-4 absolute: f32 sums in another order) on random values,
  and bit for bit with bf16 outputs on small integers (every sum exact,
  one rounding); against graphax's `_win_matmul_call` and
  `_win_bwd_dense_call` (Pallas, interpret mode) at TOL_WIN on small odd
  shapes: N off the tile, W off 8, D 1, 5, 162 and 300, and a window
  that no tile maps.
- The host's staging choice (`f32_copy_values` and the staging names the
  wrappers print) at every preset width and on views that start
  mid-row.
- The ogbn-arxiv preset in f32 at toy width on the windowed strategy
  (``community_window=64``, ``dtype="float32"``): 2 train steps against
  graphax's, losses within 1e-5 relative and NFE equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.data.synthetic import make_sbm_dataset as gx_make_sbm
from graphax.kernels import pallas_tiled, pallas_windows
from graphax.train import best_config as gx_best_config
from graphax.train.loop import Trainer as GxTrainer
from graphax_torch import Trainer, make_sbm_dataset
from graphax_torch.kernels import windowed_spmm as ws
from graphax_torch.kernels.dispatch import attach_windows
from graphax_torch.sparse.graph import Graph
from graphax_torch.train import BEST_PARAMS, best_config
from graphax_torch.utils.transplant import load_graphax_params

TOL_WIN = dict(rtol=1e-5, atol=1e-4)
# the f32 core's shapes (csrc/windowed_spmm.cu: F_BM, F_BK_MM, F_BK_BD,
# 64 * F_NR_MM, 64 * F_NR_BD)
ROWS, STEP_MM, STEP_BD, COLS_MM, COLS_BD = 128, 32, 16, 192, 128


def _layout(n, tile, window, seed=0):
    """Communities of one window each plus a few random edges, except that
    the rows of window 1 take their columns from window 0, so no tile maps
    window 1."""
    rng = np.random.RandomState(seed)
    e = 8 * n
    row = rng.randint(0, n, e)
    home = np.where(row // window == 1, 0, row // window)
    col = np.clip(home * window + rng.randint(0, window, e), 0, n - 1)
    far = rng.rand(e) < 0.1
    col[far] = rng.randint(0, n, far.sum())
    key = np.unique(row * n + col)
    g = Graph.from_edges(key // n, key % n, n,
                         edge_weight=rng.rand(len(key)).astype(np.float32),
                         edge_buffer_size=len(key) + 5, device="cpu")
    wl = attach_windows(g, window=window, tile=tile).windows
    assert 1 not in set(wl.tile_win.tolist())
    return g, wl


def _fmaf(acc, a, b):
    """fmaf(a, b, acc) in f32: the exact product added in f64 and the sum
    rounded once to f32."""
    return (acc.double() + a.double() * b.double()).float()


def _chain(acc, a_of, b_of, depth, step):
    """The running f32 sums ``acc`` continued over k < depth in order, in
    steps of ``step`` k (the last one depth % step deep): acc =
    fmaf(a_of(k), b_of(k), acc)."""
    for s in range(0, depth, step):
        for k in range(s, min(s + step, depth)):
            acc = _fmaf(acc, a_of(k), b_of(k))
    return acc


def matmul_walk(wl, dense, x, addend):
    """win_matmul_f32_kernel: a CTA per (tile, 128 rows, 192 columns of
    D) over K = W, the addend added once, rows past N not stored."""
    n, d = x.shape
    tw = wl.tile_win.long()
    t_, tile, w = wl.block_shape
    slab = ws._slab(x.float(), wl)[tw]                     # [T, W, D]
    add = ws._tiles(addend.float(), wl)
    out = torch.zeros(t_ * tile, d)
    for m0 in range(0, tile, ROWS):
        for c0 in range(0, d, COLS_MM):
            a = dense.float()[:, m0:m0 + ROWS]             # [T, m, W]
            b = slab[:, :, c0:c0 + COLS_MM]                # [T, W, c]
            acc = _chain(torch.zeros(t_, a.shape[1], b.shape[2]),
                         lambda k: a[:, :, k, None], lambda k: b[:, None, k],
                         w, STEP_MM)
            v = acc + add[:, m0:m0 + ROWS, c0:c0 + COLS_MM]
            rows = (torch.arange(t_)[:, None] * tile + m0
                    + torch.arange(a.shape[1])).reshape(-1)
            out[rows, c0:c0 + b.shape[2]] = v.reshape(-1, b.shape[2])
    return out[:n].to(x.dtype)


def bwd_dense_walk(wl, g, x, out_dtype=torch.float32):
    """win_bwd_dense_f32_kernel: a CTA per (tile, 128 rows, 128 slab
    rows) over K = D; g and slab rows past N are zeros."""
    tw = wl.tile_win.long()
    gt = ws._tiles(g.float(), wl)                          # [T, tile, D]
    slab = ws._slab(x.float(), wl)[tw]                     # [T, W, D]
    t_, tile, w = wl.block_shape
    out = torch.zeros(t_, tile, w)
    for m0 in range(0, tile, ROWS):
        for n0 in range(0, w, COLS_BD):
            a, b = gt[:, m0:m0 + ROWS], slab[:, n0:n0 + COLS_BD]
            out[:, m0:m0 + ROWS, n0:n0 + COLS_BD] = _chain(
                torch.zeros(t_, a.shape[1], b.shape[1]),
                lambda k: a[:, :, k, None], lambda k: b[:, None, :, k],
                g.shape[1], STEP_BD)
    return out.to(out_dtype)


def slab_walk(wl, dense, g, out_dtype=torch.float32):
    """win_bwd_slab_f32_kernel: a CTA per (window, 128 slab rows, 192
    columns of D) over its tiles in the CSR's order, each tile's rows in
    steps of 32 (the last one tile % 32 deep); slab rows past N not
    stored; a window no tile maps gives zeros."""
    n, d = g.shape
    gt = ws._tiles(g.float(), wl)
    t_, tile, w = wl.block_shape
    out = torch.zeros(wl.num_windows * w, d)
    ptr = wl.win_ptr.tolist()
    for win in range(wl.num_windows):
        tiles = wl.win_tiles[ptr[win]:ptr[win + 1]].tolist()
        for m0 in range(0, w, ROWS):
            for c0 in range(0, d, COLS_MM):
                a = dense.float()[:, :, m0:m0 + ROWS]
                b = gt[:, :, c0:c0 + COLS_MM]
                acc = torch.zeros(a.shape[2], b.shape[2])
                for t in tiles:
                    acc = _chain(acc, lambda r: a[t, r, :, None],
                                 lambda r: b[t, r, None], tile, STEP_MM)
                out[win * w + m0:win * w + m0 + a.shape[2],
                    c0:c0 + b.shape[2]] = acc
    return out[:n].to(out_dtype)


# (N, tile, W, D): N off the tile, W off 8, D 1, 5, 162 and 300 (two
# column chunks of win_matmul and win_bwd_slab); one at the slice's tile
# (a CTA of 128 rows) with W = 384 (three column blocks of win_bwd_dense)
CASES = {"d1": (203, 4, 12, 1), "d5": (203, 6, 18, 5),
         "d162": (203, 6, 18, 162), "d300": (203, 4, 12, 300),
         "tile128": (701, 128, 384, 7)}


def _operands(wl, g, d, seed, ints=False):
    rng = np.random.RandomState(seed)
    n = wl.num_nodes
    if ints:
        vals = torch.from_numpy(rng.randint(-4, 5, g.edge_buffer_size)
                                .astype(np.float32))
        x, gr, add = (torch.from_numpy(rng.randint(-8, 9, (n, d))
                                       .astype(np.float32)) for _ in range(3))
    else:
        vals = g.edge_weight
        x, gr, add = (torch.from_numpy(rng.randn(n, d).astype(np.float32))
                      for _ in range(3))
    return ws.densify(wl, vals, torch.float32), x, gr, add


@pytest.mark.parametrize("case", sorted(CASES))
def test_walks_match_plain(case):
    n, tile, window, d = CASES[case]
    g, wl = _layout(n, tile, window)
    assert n % tile and wl.num_windows * window > n
    dense, x, gr, add = _operands(wl, g, d, 1)
    torch.testing.assert_close(matmul_walk(wl, dense, x, add),
                               ws.win_matmul_plain(wl, dense, x, add),
                               **TOL_WIN)
    torch.testing.assert_close(bwd_dense_walk(wl, gr, x),
                               ws.win_bwd_dense_plain(wl, gr, x), **TOL_WIN)
    slab = slab_walk(wl, dense, gr)
    torch.testing.assert_close(slab, ws.win_bwd_slab_plain(wl, dense, gr),
                               **TOL_WIN)
    assert not slab[window:2 * window].any()      # the window no tile maps
    # small integers: every sum exact, the bf16 outputs one rounding of it
    dense, x, gr, add = _operands(wl, g, d, 2, ints=True)
    assert torch.equal(matmul_walk(wl, dense, x, add),
                       ws.win_matmul_plain(wl, dense, x, add))
    for od in (torch.float32, torch.bfloat16):
        assert torch.equal(bwd_dense_walk(wl, gr, x, od),
                           ws.win_bwd_dense_plain(wl, gr, x, od))
        assert torch.equal(slab_walk(wl, dense, gr, od),
                           ws.win_bwd_slab_plain(wl, dense, gr, od))


@pytest.mark.parametrize("case", sorted(CASES))
def test_walks_match_graphax(case):
    n, tile, window, d = CASES[case]
    g, wl = _layout(n, tile, window, seed=3)
    dense, x, gr, add = _operands(wl, g, d, 4)
    t_, wn = wl.num_tiles, wl.num_windows
    tw = jnp.asarray(wl.tile_win.numpy(), jnp.int32)
    slab = pallas_windows._slab(jnp.asarray(x.numpy()), wn, window)
    want = pallas_windows._win_matmul_call(jnp.asarray(dense.numpy()), slab,
                                           tw)
    want = np.asarray(want).reshape(t_ * tile, d)[:n] + add.numpy()
    np.testing.assert_allclose(matmul_walk(wl, dense, x, add).numpy(), want,
                               **TOL_WIN)
    gp = jnp.pad(jnp.asarray(gr.numpy()), ((0, t_ * tile - n), (0, 0)))
    want = pallas_windows._win_bwd_dense_call(gp.reshape(t_, tile, d), slab,
                                              tw)
    np.testing.assert_allclose(bwd_dense_walk(wl, gr, x).numpy(),
                               np.asarray(want), **TOL_WIN)


# ----------------------------------------------------------------------
# the host's staging choice

def _preset_widths():
    return sorted({(best_config(ds).hidden_dim,
                    best_config(ds).community_window or 512)
                   for ds in BEST_PARAMS})


def _values(d, *ts):
    """The copy width the f32 kernels may take: the largest of 4, 2 values
    that divides D and every start."""
    for v in (4, 2):
        if d % v == 0 and all(t.data_ptr() % (4 * v) == 0 for t in ts):
            return v
    return 1


@pytest.mark.parametrize("d,w", _preset_widths() + [(7, 18), (1, 12)])
def test_f32_staging_at_every_preset_width(d, w):
    dense = torch.zeros(3, 8, w)
    x, g, add = torch.zeros(40, d), torch.zeros(40, d), torch.zeros(40, d)
    assert x.data_ptr() % 16 == 0 and dense.data_ptr() % 16 == 0
    v = 4 if d % 4 == 0 else 2 if d % 2 == 0 else 1
    assert ws.f32_copy_values(d, x, add) == v
    assert ws.matmul_staging(dense, x, add) == f"fma cp.async 4/{4 * v}"
    assert ws.bwd_dense_staging(g, x) == "fma cp.async 4/4"
    vw = 4 if w % 4 == 0 else 2 if w % 2 == 0 else 1
    assert ws.slab_staging(dense, g) == f"fma cp.async {4 * vw}/{4 * v}"
    # views: one row in (D values in), one value in (mid-row)
    for xv in (x[1:], x.reshape(-1)[1:1 + 39 * d].view(39, d)):
        vx = _values(d, xv)
        assert vx <= v
        assert ws.matmul_staging(dense, xv, add[:39]) == \
            f"fma cp.async 4/{4 * vx}"
        assert ws.slab_staging(dense, xv) == f"fma cp.async {4 * vw}/{4 * vx}"
    mid = x.reshape(-1)[1:1 + 39 * d].view(39, d)
    assert ws.f32_copy_values(d, mid) == 1
    assert ws.f32_copy_values(d, x, mid) == 1
    assert ws.matmul_staging(dense, x[:39], mid) == "fma cp.async 4/4"
    flat = torch.zeros(dense.numel() + 1)
    dm = flat[1:].view(dense.shape)
    assert ws.slab_staging(dm, g) == f"fma cp.async 4/{4 * v}"
    # bf16 keeps its own routes
    assert ws.bwd_dense_staging(g.bfloat16(), x.bfloat16()) in (
        "cp.async", "elements")


# ----------------------------------------------------------------------
# the arxiv preset in f32 at toy width on the windowed strategy

TOY = dict(hidden_dim=16, attention_dim=8, dropout=0.0, input_dropout=0.0,
           community_window=64, dtype="float32", no_early=True)
SBM = dict(num_nodes=400, num_classes=4, num_features=32, seed=0)


@pytest.fixture
def _force_windowed(monkeypatch):
    monkeypatch.setattr(pallas_windows, "FORCE", True)
    monkeypatch.setattr(pallas_tiled, "FORCE", True)


def test_arxiv_preset_f32_windowed_steps_match_graphax(_force_windowed):
    gtr = GxTrainer(gx_best_config("ogbn-arxiv", **TOY), gx_make_sbm(**SBM))
    assert gtr.data.graph.strategy == "windowed"
    state = gtr.init_state()
    # random Q/K separate the pinned values (see tests/test_torch_slice.py)
    att = state.params["block"]["att_layer"]
    rng = np.random.RandomState(7)
    for name in ("Q", "K"):
        att[name]["w"] = jnp.asarray(0.4 * rng.randn(*att[name]["w"].shape),
                                     jnp.float32)
    tr = Trainer(best_config("ogbn-arxiv", **TOY),
                 make_sbm_dataset(**SBM, strategy="sparse", device="cpu"),
                 device="cpu")
    assert tr.data.graph.strategy == "windowed"
    assert tr.model.state_dim == 16
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    load_graphax_params(tr.model, to_np(state.params),
                        to_np(state.model_state))
    for _ in range(2):
        state, loss = gtr.train_step(state)
        got = tr.train_step()
        np.testing.assert_allclose(got, float(loss), rtol=1e-5)
        assert tr.fm.get_value() == gtr.fm.get_value()
        assert tr.bm.get_value() == gtr.bm.get_value() > 0
