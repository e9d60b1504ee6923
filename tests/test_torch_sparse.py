"""graphax_torch.sparse against graphax.sparse on the CPU.

Inputs are made with numpy from a seed and handed to both packages. Graphs
include empty rows, duplicate edges and padded slots, as in
tests/test_sparse_ops.py. Tolerances: integer layouts and host-built
topology must be equal; f32 segment ops agree to 1e-6 relative (sums in
another order); the quantile is the same histogram algorithm in f32 and
agrees to 1e-6."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from graphax.blocks.common import normalize_graph as gx_normalize_graph
from graphax.sparse import build as gx_build
from graphax.sparse import ops as gx_ops
from graphax.sparse.quantile import refined_masked_quantile as gx_quantile
from graphax.train import Config as GxConfig

from graphax_torch.blocks.common import normalize_graph
from graphax_torch.sparse import build, ops
from graphax_torch.sparse.graph import Graph
from graphax_torch.sparse.quantile import refined_masked_quantile
from graphax_torch.train import Config

CPU = "cpu"


def random_edges(n=37, e=150, seed=0, isolated=5):
    """Edges with duplicates, leaving the last ``isolated`` nodes empty."""
    rng = np.random.RandomState(seed)
    row = rng.randint(0, n - isolated, e)
    col = rng.randint(0, n - isolated, e)
    row[:10] = row[10:20]          # guaranteed duplicates
    col[:10] = col[10:20]
    w = rng.rand(e) + 0.1
    return row, col, w


def both_graphs(n=37, e=150, seed=0, self_loop=1.0, pad=16):
    row, col, w = random_edges(n, e, seed)
    gx = gx_build.build_graph(row, col, n, edge_weight=w,
                              self_loop_weight=self_loop, pad_multiple=pad,
                              strategy="edge")
    pt = build.build_graph(row, col, n, edge_weight=w,
                           self_loop_weight=self_loop, pad_multiple=pad,
                           strategy="sparse", device=CPU)
    return gx, pt


@pytest.mark.parametrize("self_loop", [0.0, 1.0, 2.5])
@pytest.mark.parametrize("undirected", [False, True])
def test_build_graph_matches_graphax(self_loop, undirected):
    row, col, w = random_edges(seed=3)
    gx = gx_build.build_graph(row, col, 37, edge_weight=w,
                              self_loop_weight=self_loop,
                              make_undirected=undirected, strategy="edge")
    pt = build.build_graph(row, col, 37, edge_weight=w,
                           self_loop_weight=self_loop,
                           make_undirected=undirected, strategy="sparse",
                           device=CPU)
    assert pt.num_edges == int(gx.num_edges)
    assert pt.edge_buffer_size == gx.edge_buffer_size
    np.testing.assert_array_equal(pt.row.numpy(), np.asarray(gx.row))
    np.testing.assert_array_equal(pt.col.numpy(), np.asarray(gx.col))
    np.testing.assert_array_equal(pt.edge_weight.numpy(),
                                  np.asarray(gx.edge_weight))
    np.testing.assert_array_equal(pt.edge_mask.numpy(),
                                  np.asarray(gx.edge_mask))


def test_csr_and_csc_layouts():
    _, g = both_graphs(seed=4, self_loop=0.0)
    e, n = g.num_edges, g.num_nodes
    row, col = g.row[:e].numpy(), g.col[:e].numpy()
    np.testing.assert_array_equal(
        g.csr.ptr.numpy(), np.searchsorted(row, np.arange(n + 1)))
    np.testing.assert_array_equal(g.csr.idx.numpy(), col)
    perm = g.csc.perm.numpy()
    np.testing.assert_array_equal(np.sort(perm), np.arange(e))
    # CSC slots sorted by (col, row), each pointing at its edge
    keys = col[perm] * n + row[perm]
    assert np.all(np.diff(keys) >= 0)
    np.testing.assert_array_equal(g.csc.seg.numpy(), col[perm])
    np.testing.assert_array_equal(g.csc.idx.numpy(), row[perm])
    np.testing.assert_array_equal(
        g.csc.ptr.numpy(), np.searchsorted(np.sort(col), np.arange(n + 1)))
    # isolated nodes own empty segments
    assert np.all(np.diff(g.csr.ptr.numpy())[-5:] == 0)


def test_from_edges_rejects_unsorted():
    with pytest.raises(ValueError):
        Graph.from_edges([1, 0], [0, 1], 2)


def test_auto_strategy_resolves_like_graphax():
    row, col, w = random_edges()
    g = build.build_graph(row, col, 37, device=CPU)          # N <= 20k: dense
    assert g.strategy == "dense"
    assert g.csr.num_slots == g.num_edges == g.csc.num_slots
    g = build.build_graph(row, col, 37, strategy="auto", dense_threshold=10,
                          device=CPU)
    assert g.strategy == "sparse"


@pytest.mark.parametrize("data_norm", ["rw", "gcn"])
@pytest.mark.parametrize("self_loop", [0.0, 1.0, 0.3])
def test_normalize_graph_double_self_loops(data_norm, self_loop):
    gx, pt = both_graphs(seed=5, self_loop=self_loop)
    gcfg = GxConfig(data_norm=data_norm, self_loop_weight=self_loop)
    cfg = Config(data_norm=data_norm, self_loop_weight=self_loop)
    want = np.asarray(gx_normalize_graph(gcfg, gx).edge_weight)
    got = normalize_graph(cfg, pt).edge_weight.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.all(got[pt.num_edges:] == 0)


@pytest.mark.parametrize("norm_dim", [0, 1])
def test_rw_norm_matches_graphax(norm_dim):
    gx, pt = both_graphs(seed=6)
    want = gx_ops.rw_norm_weights(gx.row, gx.col, gx.edge_weight, 37,
                                  norm_dim=norm_dim, mask=gx.edge_mask)
    got = ops.rw_norm_weights(pt.row, pt.col, pt.edge_weight, 37,
                              norm_dim=norm_dim, mask=pt.edge_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("heads", [1, 3])
def test_segment_softmax_matches_graphax(heads):
    gx, pt = both_graphs(seed=7)
    rng = np.random.RandomState(8)
    s = rng.randn(pt.edge_buffer_size, heads).astype(np.float32) * 3
    want = gx_ops.segment_softmax(jnp.asarray(s), gx.row, 37,
                                  mask=gx.edge_mask)
    got = ops.segment_softmax(torch.from_numpy(s), pt.row, 37,
                              mask=pt.edge_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert np.all(got.numpy()[pt.num_edges:] == 0)


def test_spmm_and_sddmm_dot_match_graphax():
    gx, pt = both_graphs(seed=9)
    rng = np.random.RandomState(10)
    x = rng.randn(37, 5).astype(np.float32)
    want = gx_ops.spmm(gx.row, gx.col, gx.edge_weight, jnp.asarray(x), 37)
    got = ops.spmm(pt.row, pt.col, pt.edge_weight, torch.from_numpy(x), 37)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    q = rng.randn(37, 2, 4).astype(np.float32)
    k = rng.randn(37, 2, 4).astype(np.float32)
    want = gx_ops.sddmm_dot(gx.row, gx.col, jnp.asarray(q), jnp.asarray(k))
    got = ops.sddmm_dot(pt.row, pt.col, torch.from_numpy(q),
                        torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("q", [0.0, 0.19, 0.5, 0.8105, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_refined_quantile_matches_graphax(q, dtype):
    rng = np.random.RandomState(11)
    e = 3000
    v = rng.exponential(size=e).astype(np.float32) * 1e-3
    v[::7] = v[::7].round(5)              # ties
    mask = np.ones(e, bool)
    mask[-200:] = False                   # padded slots
    v[-200:] = 0.0
    jv = jnp.asarray(v).astype(dtype)
    tv = torch.from_numpy(v).to(getattr(torch, dtype))
    want = gx_quantile(jv, jnp.asarray(mask), q)
    got = refined_masked_quantile(tv, torch.from_numpy(mask), q)
    assert got.dtype == tv.dtype
    np.testing.assert_allclose(float(got.float()),
                               float(jnp.asarray(want, jnp.float32)),
                               rtol=1e-6)
    # the kept set at the threshold is identical
    keep_gx = np.asarray((jv > want) & jnp.asarray(mask))
    keep_pt = ((tv > got) & torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(keep_pt, keep_gx)


def test_refined_quantile_near_torch_quantile():
    rng = np.random.RandomState(12)
    v = rng.rand(5000).astype(np.float32)
    mask = np.ones(5000, bool)
    got = refined_masked_quantile(torch.from_numpy(v),
                                  torch.from_numpy(mask), 0.3)
    want = torch.quantile(torch.from_numpy(v), 0.3)
    assert abs(float(got) - float(want)) <= 1e-6


def test_graph_to_device_keeps_layouts():
    _, g = both_graphs(seed=13)
    h = g.to("cpu")
    assert h.num_edges == g.num_edges and h.csc.perm is not None
    np.testing.assert_array_equal(h.csc.perm.numpy(), g.csc.perm.numpy())
