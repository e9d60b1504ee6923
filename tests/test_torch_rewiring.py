"""Rewiring in the port against graphax, on the CPU: the oracles of
graphax's tests/test_rewiring.py re-run on the port, the rewired edge sets
against graphax's from the same weights, and fits with a kNN rewire at
epoch 2 against graphax's epoch by epoch.

The tie rule: graphax's ``lax.top_k`` breaks ties by the lower index and
``torch.topk`` promises no order, and the two compute each distance with
their own f32 rounding. So kNN neighbour sets are compared on the rows
whose k-th and (k+1)-th distances lie more than ``KNN_GAP`` (f32 rounding
of distances of size ~10 to ~100, with room) apart, and the chosen
distances on every row, within ``KNN_TOL``. Where a selection is by value
(edge sampling's quantile), edges whose score lies within ``SCORE_GAP``
of the threshold may go either way and are left out of the comparison.
A fit is compared only where each rewire's neighbour sets are well
separated on every row (asserted first): the loss per epoch within 1e-4
relative and NFE equal."""

import dataclasses
import os
import tempfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.data.synthetic import make_sbm_dataset as gx_make_sbm
from graphax.models import make_gnn as gx_make_gnn
from graphax.rewiring import add_edges as gx_add_edges
from graphax.rewiring import apply_gdc_rewiring as gx_apply_gdc
from graphax.rewiring import apply_knn as gx_apply_knn
from graphax.rewiring import apply_pos_dist_rewire as gx_pos_dist
from graphax.rewiring import apply_two_hop_rewiring as gx_two_hop
from graphax.rewiring import edge_sampling as gx_edge_sampling
from graphax.rewiring import knn_graph as gx_knn_graph
from graphax.rewiring import make_symmetric as gx_make_symmetric
from graphax.train import Config as GxConfig
from graphax.train.loop import Trainer as GxTrainer

from graphax_torch import Trainer, make_sbm_dataset
from graphax_torch.models import GNN
from graphax_torch.models.gnn_knn import GNNKNN
from graphax_torch.rewiring import (
    add_edges, apply_beltrami, apply_gdc_rewiring, apply_knn,
    apply_pos_dist_rewire, apply_two_hop_rewiring, deepwalk_embeddings,
    dirichlet_energy, edge_sampling, knn_graph, make_symmetric,
    poincare_distances, rewire_graph_with_edges,
)
from graphax_torch.rewiring.knn import knn_distances
from graphax_torch.sparse import build
from graphax_torch.train import Config
from graphax_torch.utils.transplant import load_graphax_params

KNN_GAP = 1e-4
KNN_TOL = dict(rtol=1e-5, atol=1e-4)
SCORE_GAP = 1e-5
LOSS_RTOL = 1e-4
to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)


def _dense(graph):
    n, e = graph.num_nodes, graph.num_edges
    a = np.zeros((n, n))
    np.add.at(a, (graph.row[:e].numpy(), graph.col[:e].numpy()),
              graph.edge_weight[:e].numpy())
    return a


def _edge_set(row, col):
    return set(zip(np.asarray(row).tolist(), np.asarray(col).tolist()))


def _graph_edges(g):
    e = int(g.num_edges)
    return _edge_set(np.asarray(g.row)[:e], np.asarray(g.col)[:e])


# ----------------------------------------------------------------------
# graphax's oracles (tests/test_rewiring.py:27-185) on the port

def test_knn_graph_matches_bruteforce():
    rng = np.random.RandomState(0)
    x = rng.randn(60, 5).astype(np.float32)
    row, col = knn_graph(x, k=4)
    assert row.shape == (240,)
    d = ((x[:, None] - x[None]) ** 2).sum(-1)
    for i in range(60):
        kth = np.sort(d[i])[3]
        assert all(d[i, j] <= kth + 1e-5 for j in col[row == i])


def test_knn_zero_rows_isolated():
    x = np.random.RandomState(1).randn(30, 4).astype(np.float32)
    x[5] = 0.0
    row, col = knn_graph(x, k=3)
    assert 5 not in set(col[row != 5].tolist())


def test_knn_symmetrized():
    x = np.random.RandomState(2).randn(40, 3).astype(np.float32)
    row, col = knn_graph(x, k=3, sym=True)
    d = np.zeros((40, 40))
    np.add.at(d, (row, col), 1)
    np.testing.assert_array_equal(d > 0, (d > 0).T)


def test_rewire_keeps_capacity_when_fits():
    data = make_sbm_dataset(num_nodes=100, seed=0, device="cpu")
    g = data.graph
    r, c = g.row[:50].numpy(), g.col[:50].numpy()
    g2 = rewire_graph_with_edges(g, r, c, self_loop_weight=1.0)
    assert g2.edge_buffer_size == g.edge_buffer_size
    assert g2.strategy == g.strategy


def test_add_edges_random_dedup():
    data = make_sbm_dataset(num_nodes=80, seed=1, device="cpu")
    cfg = Config(edge_sampling_add=0.5, edge_sampling_add_type="random")
    r, c = add_edges(np.random.RandomState(3), data.graph, cfg)
    assert len(_edge_set(r, c)) == len(r)
    assert len(r) >= data.graph.num_edges
    # the same edges as graphax's from the same RandomState
    gd = gx_make_sbm(num_nodes=80, seed=1)
    gr, gc = gx_add_edges(np.random.RandomState(3), gd.graph,
                          GxConfig(edge_sampling_add=0.5,
                                   edge_sampling_add_type="random"))
    assert _edge_set(r, c) == _edge_set(gr, gc)


def test_two_hop_and_gdc_rewiring():
    data = make_sbm_dataset(num_nodes=60, seed=2, device="cpu")
    d2 = apply_two_hop_rewiring(data)
    assert d2.graph.num_edges >= data.graph.num_edges
    cfg = Config(gdc_method="ppr", gdc_sparsification="topk", gdc_k=8,
                 ppr_alpha=0.05)
    d3 = apply_gdc_rewiring(data, cfg)
    assert ((_dense(d3.graph) > 0).sum(axis=0) <= 8).all()
    # graphax's graphs: the same edges and weights
    gd = gx_make_sbm(num_nodes=60, seed=2)
    assert _graph_edges(d2.graph) == _graph_edges(gx_two_hop(gd).graph)
    g3 = gx_apply_gdc(gd, GxConfig(gdc_method="ppr", gdc_sparsification="topk",
                                   gdc_k=8, ppr_alpha=0.05)).graph
    np.testing.assert_allclose(_dense(d3.graph), np.asarray(g3.to_dense()),
                               rtol=1e-6, atol=1e-7)
    assert d3.graph.strategy == "dense" == g3.strategy


def test_make_symmetric_and_dirichlet():
    data = make_sbm_dataset(num_nodes=50, seed=3, device="cpu")
    r, c, w = make_symmetric(data.graph)
    dense = np.zeros((50, 50))
    np.add.at(dense, (r, c), w)
    colsum = dense.sum(axis=0)
    touched = colsum > 0
    np.testing.assert_allclose(colsum[touched], 1.0, rtol=1e-5)
    gd = gx_make_sbm(num_nodes=50, seed=3)
    gr, gc, gw = gx_make_symmetric(gd.graph)
    np.testing.assert_array_equal(r, gr)
    np.testing.assert_array_equal(c, gc)
    np.testing.assert_allclose(w, gw, rtol=1e-6)
    de = dirichlet_energy(data.graph, data.x[:, :4])
    assert de.shape == (4, 4)
    x4 = data.x[:, :4].numpy().astype(np.float64)
    np.testing.assert_allclose(de, x4.T @ _dense(data.graph) @ x4, rtol=1e-5,
                               atol=1e-4)


def test_poincare_distances():
    emb = np.asarray([[0.0, 0.0], [0.5, 0.0], [0.0, 0.5]])
    d = poincare_distances(emb)
    np.testing.assert_allclose(np.diag(d), 0.0, atol=1e-9)
    np.testing.assert_allclose(d, d.T, rtol=1e-9)
    want = np.arccosh(1 + 2 * 0.25 / (1 - 0.25))
    np.testing.assert_allclose(d[0, 1], want, rtol=1e-9)


def test_pos_dist_rewire_matches_graphax():
    """kNN and quantile rewiring from the positional encodings' distances,
    hyperbolic and euclidean: graphax's edges."""
    pd = make_sbm_dataset(num_nodes=40, seed=3, device="cpu")
    gd = gx_make_sbm(num_nodes=40, seed=3)
    emb = 0.3 * np.random.RandomState(5).rand(40, 3)
    pd, gd = pd.with_pos_encoding(emb), gd.with_pos_encoding(jnp.asarray(
        emb, jnp.float32))
    for kw in (dict(threshold_type="topk_adj", rewire_KNN_k=4),
               dict(threshold_type="pos_dist", pos_dist_quantile=0.05)):
        for space in ("hyperbolic", "euclidean"):
            got = apply_pos_dist_rewire(pd, Config(**kw), space=space).graph
            want = gx_pos_dist(gd, GxConfig(**kw), space=space).graph
            assert _graph_edges(got) == _graph_edges(want)


def test_beltrami_gdc_cache_roundtrip():
    data = make_sbm_dataset(num_nodes=40, num_classes=3, seed=4,
                            device="cpu")
    cfg = Config(dataset="ToyDs", pos_enc_type="GDC", gdc_k=8,
                 pos_enc_hidden_dim=8)
    with tempfile.TemporaryDirectory() as td:
        enc = apply_beltrami(data, cfg, cache_dir=td)
        assert enc.shape[0] == 40
        assert os.path.exists(os.path.join(td, "pos_encodings",
                                           "ToyDs_GDC.pkl"))
        np.testing.assert_allclose(enc, apply_beltrami(data, cfg,
                                                       cache_dir=td))


def test_deepwalk_embeddings():
    data = make_sbm_dataset(num_nodes=60, num_classes=3, p_in=0.2,
                            p_out=0.01, seed=5, device="cpu")
    g = data.graph
    e = g.num_edges
    emb, acc = deepwalk_embeddings(g.row[:e].numpy(), g.col[:e].numpy(), 60,
                                   dim=8, labels=data.y.numpy(), epochs=1,
                                   walks_per_node=5, walk_length=10,
                                   device="cpu")
    assert emb.shape == (60, 8) and np.isfinite(emb).all()
    assert 0.0 <= acc <= 1.0


def _knn_cfg(**kw):
    d = dict(hidden_dim=8, rewire_KNN=True, rewire_KNN_T="T0",
             rewire_KNN_k=6, method="euler", step_size=0.5,
             self_loop_weight=1.0, input_dropout=0.0, dropout=0.0)
    d.update(kw)
    return GxConfig(**d), Config(**d)


def _models(gcfg, cfg, num_classes, maker=GNN):
    gm = gx_make_gnn(gcfg, 8, num_classes)
    params, state = gm.init(jax.random.PRNGKey(0))
    model = maker(cfg, 8, num_classes)
    load_graphax_params(model, to_np(params), to_np(state))
    return gm, params, state, model


def _check_knn_sets(z, k, row, col, grow, gcol, rows_gap=True):
    """Distances within KNN_TOL on every row; the sets equal on the rows
    whose k-th and (k+1)-th distances are more than KNN_GAP apart.
    Returns the share of such rows."""
    zz = torch.as_tensor(z, dtype=torch.float64)
    d = ((zz[:, None] - zz[None]) ** 2).sum(-1).numpy()
    n = d.shape[0]
    srt = np.sort(d, axis=1)
    gap = srt[:, k] - srt[:, k - 1] > KNN_GAP
    mine = col.reshape(n, k)
    theirs = gcol.reshape(n, k)
    np.testing.assert_allclose(np.sort(np.take_along_axis(d, mine, 1), 1),
                               np.sort(np.take_along_axis(d, theirs, 1), 1),
                               **KNN_TOL)
    for r in np.nonzero(gap)[0]:
        assert set(mine[r]) == set(theirs[r]), r
    return gap.mean()


def test_knn_graph_matches_graphax_with_the_tie_rule():
    """``knn_graph`` on the same embedding, 200 rows, in blocks of 64."""
    z = np.random.RandomState(7).randn(200, 10).astype(np.float32)
    row, col = knn_graph(z, 7, block_size=64)
    grow, gcol = gx_knn_graph(z, 7, block_size=64)
    np.testing.assert_array_equal(row, grow)
    assert _check_knn_sets(z, 7, row, col, grow, gcol) > 0.9
    d, _ = knn_distances(torch.from_numpy(z), 7)
    assert bool((d[:, 1:] >= d[:, :-1]).all())      # nearest first


def test_apply_knn_through_model():
    data = make_sbm_dataset(num_nodes=80, num_features=8, seed=6,
                            device="cpu")
    gcfg, cfg = _knn_cfg()
    gd = gx_make_sbm(num_nodes=80, num_features=8, seed=6)
    gm, params, state, model = _models(gcfg, cfg, data.num_classes)
    g2 = apply_knn(cfg, model, data)
    assert g2.num_edges > 0 and g2.num_nodes == 80
    want = gx_apply_knn(gcfg, gm, params, state, gd)
    z, _ = gm.encode(params, state, gd.x, train=False, apply_dropout=False)
    zr, zc = gx_knn_graph(z, 6)
    mr, mc = knn_graph(model.encode(data.x, train=False).detach(), 6)
    assert _check_knn_sets(np.asarray(z), 6, mr, mc, zr, zc) == 1.0
    assert _graph_edges(g2) == _graph_edges(want)
    assert g2.edge_buffer_size == int(want.edge_buffer_size)


def test_fa_layer_model():
    data = make_sbm_dataset(num_nodes=60, num_features=8, seed=7,
                            device="cpu")
    _, cfg = _knn_cfg(rewire_KNN=False, fa_layer=True)
    model = GNNKNN(cfg, 8, data.num_classes)
    model.reset_parameters(torch.Generator().manual_seed(0))
    assert any(k.startswith("fa_block.") for k in model.state_dict())
    fa_graph = build.build_graph(*build.full_adjacency(60), 60,
                                 self_loop_weight=1.0, device="cpu")
    model.eval()
    with torch.no_grad():
        logits, _ = model(data.graph, data.x, train=False, fa_graph=fa_graph)
        logits2, _ = model(data.graph, data.x, train=False)
    assert logits.shape == logits2.shape == (60, data.num_classes)
    assert not torch.allclose(logits, logits2)
    # without the fa layer the kNN model holds the plain model's parameters
    _, cfg2 = _knn_cfg()
    assert set(GNNKNN(cfg2, 8, 3).state_dict()) == \
        set(GNN(cfg2, 8, 3).state_dict())


def test_trainer_with_knn_rewiring():
    data = make_sbm_dataset(num_nodes=90, num_features=8, num_classes=3,
                            p_in=0.15, p_out=0.01, seed=8, device="cpu")
    cfg = Config(hidden_dim=8, rewire_KNN=True, rewire_KNN_T="T0",
                 rewire_KNN_k=5, rewire_KNN_epoch=2, method="euler",
                 step_size=0.5, time=1.0, self_loop_weight=1.0,
                 input_dropout=0.1, dropout=0.1, lr=0.02, no_early=True)
    trainer = Trainer(cfg, data, device="cpu")
    out = trainer.fit(epochs=4)
    assert np.isfinite(out["history"][-1]["loss"])
    assert trainer.data.graph.num_edges != data.graph.num_edges


# ----------------------------------------------------------------------
# the rewired edges and fits against graphax's

def test_edge_sampling_matches_graphax():
    """Importance addition from the same RandomState, then removal by the
    attention quantile (the hard block's attention layer, random weights):
    graphax's kept edges, but for those whose score lies within SCORE_GAP
    of the quantile."""
    over = dict(block="hard_attention", hidden_dim=8, heads=2,
                attention_dim=8, edge_sampling=True,
                edge_sampling_add_type="importance", edge_sampling_add=0.3,
                edge_sampling_rmv=0.3, self_loop_weight=1.0,
                input_dropout=0.0, dropout=0.0)
    gcfg, cfg = GxConfig(**over), Config(**over)
    gd = gx_make_sbm(num_nodes=70, num_features=8, seed=9)
    pd = make_sbm_dataset(num_nodes=70, num_features=8, seed=9, device="cpu")
    gm, params, state, model = _models(gcfg, cfg, pd.num_classes)
    rng = np.random.RandomState(4)
    att = params["block"]["att_layer"]
    for name in ("Q", "K"):
        att[name] = {k: jnp.asarray(rng.randn(*att[name][k].shape) * s,
                                    jnp.float32)
                     for k, s in (("w", 0.5), ("b", 0.1))}
    load_graphax_params(model, to_np(params), to_np(state))
    model.eval()
    from graphax.rewiring.sampling import _block_attention
    from graphax_torch.rewiring.sampling import block_attention

    z, _ = gm.encode(params, state, gd.x, train=False, apply_dropout=False)
    gmean, _, _ = _block_attention(gm, params["block"], gcfg, gd.graph, z)
    with torch.no_grad():
        zp = model.encode(pd.x, train=False)
    pmean, _, _ = block_attention(model, cfg, pd.graph, zp)
    np.testing.assert_allclose(pmean, gmean, rtol=1e-5, atol=1e-7)
    gr, gc = gx_add_edges(np.random.RandomState(0), gd.graph, gcfg, gmean)
    pr, pc = add_edges(np.random.RandomState(0), pd.graph, cfg, pmean)
    assert _edge_set(pr, pc) == _edge_set(gr, gc)
    from graphax.rewiring import rewire_graph_with_edges as gx_rewire
    gdense = gx_rewire(gd.graph, gr, gc, self_loop_weight=1.0,
                       keep_capacity=False)
    pdense = rewire_graph_with_edges(pd.graph, pr, pc, self_loop_weight=1.0,
                                     keep_capacity=False)
    kr, kc = gx_edge_sampling(gm, params["block"], gcfg, gdense, z)
    mr, mc = edge_sampling(model, cfg, pdense, zp)
    vals, _, _ = block_attention(model, cfg, pdense, zp)
    e = pdense.num_edges
    thr = np.quantile(vals[:e], cfg.edge_sampling_rmv)
    near = {(int(r), int(c)) for r, c, v in zip(pdense.row[:e].numpy(),
                                                pdense.col[:e].numpy(),
                                                vals[:e])
            if abs(v - thr) <= SCORE_GAP}
    assert len(near) < 0.05 * e
    assert _edge_set(mr, mc) - near == _edge_set(kr, kc) - near
    assert len(_edge_set(mr, mc)) < e


def _fit_pair(over, epochs, gd, pd, window=False):
    """graphax's and the port's ``fit(epochs)`` from graphax's initial
    weights (the port's ``init_state`` loads them). Returns both
    histories and both trainers."""
    gtr = GxTrainer(GxConfig(**over), gd)
    st = gtr.init_state()
    tr = Trainer(Config(**over), pd, device="cpu")
    init_state = tr.init_state

    def load(seed=None):
        init_state(seed)
        load_graphax_params(tr.model, to_np(st.params),
                            to_np(st.model_state))

    tr.init_state = load
    got = tr.fit(epochs=epochs)["history"]
    want = gtr.fit(epochs=epochs)["history"]
    return got, want, tr, gtr


@pytest.mark.parametrize("window", [False, True])
def test_fit_with_knn_rewire_matches_graphax(window):
    """3 epochs with a kNN rewire at epoch 2 (T0, k = 5, self-loops), the
    hard-attention block, f32, adam: graphax's loss per epoch within 1e-4
    relative and its NFE; the rewired graph graphax's edges. With
    ``community_window`` the first epoch runs the windowed layout; the
    rewired graph comes back without windows in both packages (graphax's
    gather SpMM over the edge list, the port's CSR strategy)."""
    over = dict(block="hard_attention", hidden_dim=8, heads=2,
                attention_dim=8, rewire_KNN=True, rewire_KNN_T="T0",
                rewire_KNN_k=5, rewire_KNN_epoch=2, method="dopri5",
                time=1.0, self_loop_weight=1.0, input_dropout=0.0,
                dropout=0.0, lr=0.02, no_early=True, dtype="float32",
                att_samp_pct=0.9, optimizer="adam")
    if window:
        over["community_window"] = 16
    kw = dict(num_nodes=90, num_features=8, num_classes=3, p_in=0.15,
              p_out=0.01, seed=8)
    gd = gx_make_sbm(**kw)
    pd = make_sbm_dataset(**kw, strategy="sparse", device="cpu")
    gd = dataclasses.replace(gd, graph=dataclasses.replace(
        gd.graph, strategy="sparse"))
    got, want, tr, gtr = _fit_pair(over, 3, gd, pd)
    if window:
        assert gtr.data.graph.strategy == "windowed"
        assert gtr.data.graph.windows is None
        assert tr.data.graph.strategy == "sparse"
        assert tr.data.graph.windows is None
    assert _graph_edges(tr.data.graph) == _graph_edges(gtr.data.graph)
    assert [h["nfe"] for h in got] == [int(h["nfe"]) for h in want]
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=LOSS_RTOL)
