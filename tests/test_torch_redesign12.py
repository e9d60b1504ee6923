"""The redesigned f32 attention_kproj and bf16 win_bwd_slab, on the CPU.

- `win_bwd_slab`'s plain route with an output dtype against graphax's
  `_win_bwd_slab_call` (Pallas, interpret mode) followed by
  ``[:N].astype``, bit for bit, on a layout where no tile maps window 1
  and N is off the tile and the window. The inputs are small integers in
  bf16, so every f32 sum is exact in any order and the one rounding to
  the output dtype is the only one: both sides must give the same bits.
- `win_bwd_slab_tc_kernel`'s walk in plain PyTorch (each window's tiles in
  the window -> tiles CSR's order, each tile in chunks of 32 rows, f32
  sums, the first N slab rows rounded once) against the plain version at
  TOL_WIN (1e-5 relative, 1e-4 absolute: f32 sums of up to 4 tiles' rows
  in another order); no split of a window's tiles is modelled, since the
  kernel has none (every window of the arxiv stand-in holds 4 tiles).
- `kproj_kernel`'s walk in plain PyTorch (chunks of 32 along D, each
  output a running f32 sum of exact products in D's order, each step one
  rounding as an FMA takes it, bk last) against `attention_kproj_plain`
  at TOL_KPROJ (1e-5 relative, 1e-4 absolute) and graphax's projection
  (`dot_general` with f32 accumulation, as its kernels project each
  gathered row) at the presets' widths, D 400 with A 120, odd D and D 1.
- The gates and staging: `kproj_supported` in both dtypes at every width
  up to D 2,000 and A 512; the CUDA-core route's copy bytes and the
  staging names of the K projection and `win_bwd_slab` at every preset
  width and on views.
- The f32 pin at D 400, A 120 (which raised before the CUDA-core
  projection streamed Wk) on a small graph against graphax's
  `attention_edge_means_pallas`, interpreted, at the pin's tolerance (2e-4
  relative, 2e-5 absolute).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.functions.transformer import transformer_attention_init
from graphax.kernels import pallas_windows
from graphax.kernels.dispatch import attach_tiles
from graphax.kernels.pallas_attention import attention_edge_means_pallas
from graphax.sparse import Graph as GxGraph
from graphax.train import Config as GxConfig
from graphax_torch.functions.transformer import (
    TransformerAttention, attention_edge_means,
)
from graphax_torch.kernels import fused_attention as fa
from graphax_torch.kernels import windowed_spmm as ws
from graphax_torch.kernels.dispatch import attach_windows
from graphax_torch.sparse.graph import Graph
from graphax_torch.train import BEST_PARAMS, Config, best_config
from graphax_torch.utils.transplant import load_graphax_params

TOL_WIN = dict(rtol=1e-5, atol=1e-4)
TOL_KPROJ = dict(rtol=1e-5, atol=1e-4)


def _empty_window_layout(n=203, window=32, tile=8, seed=0):
    """Communities of one window each plus a few random edges, except that
    the rows of window 1 take their columns from window 0, so no tile maps
    window 1; N = 203 is off the tile (8) and the window (32)."""
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
    assert n % tile and n % window
    return g, wl


# ----------------------------------------------------------------------
# win_bwd_slab
# ----------------------------------------------------------------------

@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [5, 162])
def test_win_bwd_slab_plain_matches_graphax_bitwise(out_dtype, d):
    g, wl = _empty_window_layout()
    n, t, tile, w, wn = (wl.num_nodes, wl.num_tiles, wl.tile, wl.window,
                         wl.num_windows)
    rng = np.random.RandomState(d)
    # integers: exact in bf16, every product and f32 sum exact
    vals = torch.from_numpy(rng.randint(-8, 9, g.edge_buffer_size)
                            .astype(np.float32))
    dense = ws.densify(wl, vals, torch.bfloat16)
    gr = rng.randint(-16, 17, (n, d)).astype(np.float32)
    odt = getattr(torch, out_dtype)
    got = ws.win_bwd_slab(wl, dense, torch.from_numpy(gr).to(torch.bfloat16),
                          odt)
    assert got.dtype == odt and tuple(got.shape) == (n, d)

    gp = jnp.pad(jnp.asarray(gr, jnp.bfloat16), ((0, t * tile - n), (0, 0)))
    want = pallas_windows._win_bwd_slab_call(
        jnp.asarray(dense.float().numpy(), jnp.bfloat16),
        gp.reshape(t, tile, d), jnp.asarray(wl.tile_win.numpy(), jnp.int32),
        wn)
    want = np.asarray(want.reshape(wn * w, d)[:n].astype(
        getattr(jnp, out_dtype)).astype(jnp.float32))
    assert np.array_equal(got.float().numpy(), want)
    assert not got[w:2 * w].any()          # the window no tile maps
    # the rounding to bf16 is hit: some sums are not bf16 values
    if out_dtype == "bfloat16" and d == 162:
        exact = ws.win_bwd_slab(wl, dense, torch.from_numpy(gr))
        assert not torch.equal(exact, got.float())


def _slab_walk(wl, dense, g, out_dtype, chunk=32):
    """win_bwd_slab_tc_kernel in plain PyTorch: per window, its tiles in
    the CSR's order, each in chunks of ``chunk`` tile rows, summed into
    one f32 [W, D] accumulator; the first N slab rows rounded once."""
    n, d = g.shape
    w = wl.window
    gt = ws._tiles(g.float(), wl)
    out = torch.zeros(wl.num_windows * w, d)
    ptr = wl.win_ptr.tolist()
    for win in range(wl.num_windows):
        acc = torch.zeros(w, d)
        for t in wl.win_tiles[ptr[win]:ptr[win + 1]].tolist():
            for r0 in range(0, wl.tile, chunk):
                acc += dense[t, r0:r0 + chunk].float().T \
                    @ gt[t, r0:r0 + chunk]
        out[win * w:(win + 1) * w] = acc
    return out[:n].to(out_dtype)


@pytest.mark.parametrize("tile,window", [(8, 32), (64, 128)])
def test_slab_walk_matches_plain(tile, window):
    n = 1001
    rng = np.random.RandomState(tile)
    row = rng.randint(0, n, 10 * n)
    home = np.where(row // window == 1, 0, row // window)
    col = np.clip(home * window + rng.randint(0, window, row.size), 0, n - 1)
    key = np.unique(row * n + col)
    g = attach_windows(Graph.from_edges(
        key // n, key % n, n, rng.rand(len(key)).astype(np.float32),
        edge_buffer_size=len(key)), window=window, tile=tile)
    wl = g.windows
    dense = ws.densify(wl, g.edge_weight, torch.bfloat16)
    gr = torch.from_numpy(rng.randn(n, 162).astype(np.float32)) \
        .to(torch.bfloat16)
    want = ws.win_bwd_slab_plain(wl, dense, gr)
    got = _slab_walk(wl, dense, gr, torch.float32)
    torch.testing.assert_close(got, want, **TOL_WIN)
    assert not got[window:2 * window].any()
    b16 = _slab_walk(wl, dense, gr, torch.bfloat16)
    assert torch.equal(b16, got.to(torch.bfloat16))


def test_slab_staging_names_the_route():
    wl = _empty_window_layout()[1]
    dense = torch.zeros(wl.block_shape, dtype=torch.bfloat16)
    g = torch.zeros(wl.num_nodes, 162, dtype=torch.bfloat16)
    assert dense.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
    assert ws.slab_staging(dense, g) == "cp.async"
    assert ws.slab_staging(dense, g[:, :7].contiguous()) == "elements"
    flat = torch.zeros(g.numel() + 1, dtype=torch.bfloat16)
    assert ws.slab_staging(dense, flat[1:].view(g.shape)) == "elements"
    flat = torch.zeros(dense.numel() + 8, dtype=torch.bfloat16)
    assert ws.slab_staging(flat[8:].view(dense.shape), g) == "cp.async"
    assert ws.slab_staging(flat[1:1 + dense.numel()].view(dense.shape),
                           g) == "elements"


# ----------------------------------------------------------------------
# the K projection
# ----------------------------------------------------------------------

def _kproj_walk(x, wk, bk, chunk=32):
    """kproj_kernel in plain PyTorch: D in chunks of ``chunk`` (columns
    past D zero on both sides), each output a running f32 sum over D in
    order, each step the exact product added and rounded once (through
    f64, where products of f32 or bf16 values are exact), bk last."""
    n, d = x.shape
    xf, wf = x.double(), wk.double()
    acc = torch.zeros(n, wk.shape[1])
    for k0 in range(0, d, chunk):
        for k in range(k0, k0 + chunk):
            if k < d:
                acc = (acc.double() + xf[:, k:k + 1] * wf[k]).float()
    return acc + bk


def _preset_widths():
    return sorted({(best_config(ds).hidden_dim, best_config(ds).attention_dim)
                   for ds in BEST_PARAMS})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,a", _preset_widths() + [(400, 120), (161, 32),
                                                    (1, 7)])
def test_kproj_walk_matches_plain_and_graphax(dtype, d, a):
    rng = np.random.RandomState(d * 7 + a)
    n = 37
    x = rng.randn(n, d).astype(np.float32)
    wk = (rng.randn(d, a) / np.sqrt(d)).astype(np.float32)
    bk = (0.1 * rng.randn(a)).astype(np.float32)
    tdt = getattr(torch, dtype)
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(wk).to(tdt)
    got = _kproj_walk(xt, wt, torch.from_numpy(bk))
    torch.testing.assert_close(
        got, fa.attention_kproj_plain(xt, wt, torch.from_numpy(bk)),
        **TOL_KPROJ)
    jdt = getattr(jnp, dtype)
    want = jax.lax.dot_general(
        jnp.asarray(x).astype(jdt), jnp.asarray(wk).astype(jdt),
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32) + jnp.asarray(bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_kproj_supported_at_every_width():
    """Every width has a K projection in either dtype: the f32 one and bf16
    shapes that the tensor cores cannot hold on the CUDA-core kernel,
    which streams Wk with x along D; `kproj_fits`, the flash, windowed
    and column routes' gate, still refuses wide ones."""
    for d in (1, 7, 162, 400, 1000, 2000):
        for a in (1, 32, 64, 120, 512):
            for dt in (torch.float32, torch.bfloat16):
                assert fa.kproj_supported(dt, d, a)
            assert fa.kproj_route(torch.float32, d, a) == "cuda_core"
    assert not fa.kproj_supported(torch.float16, 162, 32)
    assert not fa.kproj_fits(2000, 512)
    assert fa.kproj_route(torch.bfloat16, 2000, 512) == "cuda_core"


@pytest.mark.parametrize("d,a", _preset_widths())
def test_kproj_staging_at_every_preset_width(d, a):
    """The CUDA-core kernel (f32 at every width) copies rows of x and Wk by
    16 bytes where their width divides by 4 values, by 8 where it is even,
    and a view one value in by 4; odd bf16 rows go one value per copy. The
    tensor cores take bf16 at every preset width, by whole-tile 16-byte
    copies, element copies for a view that starts mid-row."""
    x = torch.zeros(9, d)
    assert fa.kproj_route(torch.float32, d, a) == "cuda_core"
    assert fa.kproj_copy_bytes(x) == (16 if d % 4 == 0 else 8 if d % 2 == 0
                                      else 4)
    flat = torch.zeros(9 * d + 1)
    assert fa.kproj_copy_bytes(flat[1:].view(9, d)) == 4
    assert fa.kproj_copy_bytes(torch.zeros(d, a)) == (
        16 if a % 4 == 0 else 8 if a % 2 == 0 else 4)
    assert fa.kproj_copy_bytes(torch.zeros(3, 7, dtype=torch.bfloat16)) == 0
    xb = torch.zeros(9, d, dtype=torch.bfloat16)
    assert fa.kproj_route(torch.bfloat16, d, a) == "tensor_core"
    assert fa.kproj_staging(xb) == "cp.async"
    assert fa.kproj_staging(xb[1:]) == ("elements" if d * 2 % 16
                                        else "cp.async")


# ----------------------------------------------------------------------
# the f32 pin at wide rows, against graphax
# ----------------------------------------------------------------------

def test_f32_pin_at_d400_a120_matches_pallas():
    rng = np.random.RandomState(3)
    n, e, d, a, heads = 48, 260, 400, 120, 4
    row, col = rng.randint(0, n - 2, e), rng.randint(0, n, e)
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    w = (rng.rand(e) + 0.2).astype(np.float32)
    gx = GxGraph.from_edges(row, col, n, edge_weight=w, edge_buffer_size=e + 4)
    gx = dataclasses.replace(attach_tiles(gx, tile=8, block_edges=64),
                             strategy="tiled")
    pt = Graph.from_edges(row, col, n, edge_weight=w, edge_buffer_size=e + 4)
    kw = dict(function="transformer", heads=heads, attention_dim=a,
              hidden_dim=d, attention_type="scaled_dot",
              reweight_attention=True)
    gcfg, cfg = GxConfig(**kw), Config(**kw)
    p = transformer_attention_init(jax.random.PRNGKey(0), gcfg, d)
    for name in ("Q", "K"):
        p[name] = {"w": jnp.asarray(rng.randn(d, a) * 0.05, jnp.float32),
                   "b": jnp.asarray(rng.randn(a) * 0.1, jnp.float32)}
    att = TransformerAttention(cfg, d)
    load_graphax_params(att, jax.tree_util.tree_map(np.asarray, p))
    x = rng.randn(n, d).astype(np.float32)
    want = attention_edge_means_pallas(gcfg, p, gx.tiles, jnp.asarray(x),
                                       int(gx.edge_buffer_size),
                                       edge_weight=gx.edge_weight)
    assert fa.kproj_supported(torch.float32, d, a)
    with torch.no_grad():
        got = attention_edge_means(att, cfg, pt, torch.from_numpy(x),
                                   differentiable=False)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want, np.float32), rtol=2e-4,
                               atol=2e-5)
    assert np.all(got[e:].numpy() == 0)
