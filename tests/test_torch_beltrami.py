"""Beltrami (BLEND) in the port against graphax, on the CPU: DeepWalk's
encodings, the GDC functions and the encodings' cache, the Beltrami
encoder and attention, the beltrami_exp score in the pin's and flash's
plain versions against graphax's Pallas kernels in interpret mode, and a
GRAND-nl Beltrami train step.

Tolerances:
- ``random_walks`` and the probe: bit for bit (the same numpy code and
  RandomState stream).
- The skip-gram from graphax's initial embedding: 1e-5 absolute after its
  steps (adam on gathered rows; the gathers' gradients summed in another
  order).
- The GDC functions: 1e-6 (the same numpy/scipy code; float64).
- Logits of a forward: 1e-5 absolute, NFE equal.
- The kernels' plain versions against graphax's interpreted kernels:
  TOL_PIN and TOL_FLASH, rtol 2e-4 / atol 2e-5 (graphax's own attention
  tolerance); gmax TOL_GMAX, 1e-6.
- A train step: loss and every parameter's gradient within TOL_TRAIN, 1e-4
  relative plus 1e-5 absolute (f32 sums in another order through the
  solve)."""

import dataclasses
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.data import gdc as gx_gdc
from graphax.data.synthetic import make_sbm_dataset as gx_make_sbm
from graphax.functions.transformer import transformer_attention_init
from graphax.kernels.dispatch import attach_tiles
from graphax.kernels.pallas_attention import (
    _gmax_call, _prep_inputs, attention_edge_means_pallas,
    fused_attention_ax_pallas,
)
from graphax.models.gnn import make_gnn
from graphax.rewiring import apply_beltrami as gx_apply_beltrami
from graphax.rewiring import deepwalk as gx_dw
from graphax.sparse import Graph as GxGraph
from graphax.train import Config as GxConfig
from graphax.train.loop import Trainer as GxTrainer

from graphax_torch import Trainer, make_sbm_dataset
from graphax_torch.data import gdc
from graphax_torch.functions.transformer import (
    TransformerAttention, attention_edge_means, attention_route,
)
from graphax_torch.kernels import fused_attention as fa
from graphax_torch.models import GNN
from graphax_torch.rewiring import apply_beltrami, deepwalk
from graphax_torch.sparse.graph import Graph
from graphax_torch.train import Config
from graphax_torch.utils.transplant import (
    graphax_to_state_dict, load_graphax_params,
)

TOL_PIN = TOL_FLASH = dict(rtol=2e-4, atol=2e-5)
TOL_GMAX = dict(rtol=1e-6, atol=1e-6)
TOL_TRAIN = dict(rtol=1e-4, atol=1e-5)
LOGITS_ATOL = 1e-5
SBM = dict(num_nodes=60, num_classes=3, num_features=8, seed=1, p_in=0.15,
           p_out=0.02)
# the state [features 5 | positional 4], positional encodings of width 3
BEL = dict(beltrami=True, attention_type="exp_kernel", feat_hidden_dim=5,
           pos_enc_hidden_dim=4, pos_enc_dim=3, heads=2, attention_dim=8)

to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)


def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


def _sbm_edges(n=60, seed=5):
    d = gx_make_sbm(num_nodes=n, num_classes=3, p_in=0.2, p_out=0.01,
                    seed=seed)
    g = d.graph
    mask = np.asarray(g.edge_mask)
    return np.asarray(g.row)[mask], np.asarray(g.col)[mask], d


# ----------------------------------------------------------------------
# DeepWalk

def test_random_walks_and_probe_bit_for_bit():
    row, col, d = _sbm_edges()
    # node 10 keeps its walks in place when it has no out-edge
    keep = row != 10
    for args in ((row, col, 60, 20, 10, 0), (row[keep], col[keep], 60, 7, 3,
                                             4)):
        np.testing.assert_array_equal(deepwalk.random_walks(*args),
                                      gx_dw.random_walks(*args))
    emb = np.random.RandomState(2).randn(60, 8).astype(np.float32)
    labels = np.asarray(d.y)
    assert deepwalk.probe_accuracy(emb, labels, 3) == \
        gx_dw._probe_accuracy(emb, labels, 3)


def test_skipgram_matches_graphax_from_its_initial_embedding():
    """Two epochs of 5 steps of 256 pairs (the same pairs and negatives
    from one RandomState stream), from graphax's
    ``0.1 * normal(PRNGKey(seed))``."""
    row, col, _ = _sbm_edges()
    walks = gx_dw.random_walks(row, col, 60, 6, 5, seed=1)
    kw = dict(window=3, negatives=4, epochs=2, lr=0.025, batch=256, seed=7)
    want = gx_dw.skipgram_train(walks, 60, 8, **kw)
    init = np.array(0.1 * jax.random.normal(jax.random.PRNGKey(7), (60, 8)))
    got = deepwalk.skipgram_train(walks, 60, 8, device="cpu", init=init,
                                  **kw)
    assert not np.allclose(want, init, atol=1e-3)     # it trained
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_context_pairs_are_graphax_shuffle():
    """The pairs in the order graphax's ``rng.shuffle`` of the ``[P, 2]``
    array leaves them, and the stream after it where graphax's is."""
    walks = np.random.RandomState(0).randint(0, 50, size=(40, 9))
    a, b = np.random.RandomState(5), np.random.RandomState(5)
    want = np.concatenate([np.stack([walks[:, :9 - off].reshape(-1),
                                     walks[:, off:].reshape(-1)], axis=1)
                           for off in range(1, 4)], axis=0)
    a.shuffle(want)
    np.testing.assert_array_equal(deepwalk.context_pairs(walks, 3, b), want)
    assert a.randint(0, 1 << 30) == b.randint(0, 1 << 30)


def test_grouped_negatives_are_graphax_stream():
    """The port draws its negatives many batches at a time; the legacy
    RandomState gives the same values as one draw a batch."""
    a, b = np.random.RandomState(3), np.random.RandomState(3)
    one = np.concatenate([a.randint(0, 169_343, size=(16, 5))
                          for _ in range(7)])
    np.testing.assert_array_equal(one, b.randint(0, 169_343, size=(112, 5)))


# ----------------------------------------------------------------------
# GDC

@pytest.mark.parametrize("method,spars", [("ppr", "topk"),
                                          ("heat", "threshold"),
                                          ("ppr", "threshold_avg")])
def test_gdc_functions_match_graphax(method, spars):
    row, col, _ = _sbm_edges(n=40, seed=6)
    kw = dict(method=method, alpha=0.1, heat_time=2.0, k=6,
              sparsification="threshold" if spars != "topk" else "topk",
              eps=None if spars == "threshold_avg" else 1e-3,
              avg_degree=5)
    for a, b in zip(gdc.gdc_diffusion(row, col, 40, **kw),
                    gx_gdc.gdc_diffusion(row, col, 40, **kw)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    kw.pop("avg_degree")
    kw["eps"] = kw["eps"] or 1e-3
    for orient, dim in (("row", None), ("col", 6)):
        np.testing.assert_allclose(
            gdc.gdc_pos_encoding(row, col, 40, orientation=orient,
                                 embedding_dim=dim, **kw),
            gx_gdc.gdc_pos_encoding(row, col, 40, orientation=orient,
                                    embedding_dim=dim, **kw),
            rtol=1e-6, atol=1e-6)


def test_pos_encoding_cache_reads_both_ways(tmp_path):
    """A GDC encoding written by graphax loads in the port and the
    reverse; a DeepWalk pickle ``{"data", "acc"}`` likewise."""
    kw = dict(num_nodes=40, num_classes=3, seed=4)
    gd = gx_make_sbm(**kw)
    pd = make_sbm_dataset(**kw, device="cpu")
    gcfg = GxConfig(dataset="GxWrote", pos_enc_type="GDC", gdc_k=8)
    cfg = Config(dataset="GxWrote", pos_enc_type="GDC", gdc_k=8)
    want = gx_apply_beltrami(gd, gcfg, cache_dir=str(tmp_path))
    np.testing.assert_array_equal(apply_beltrami(pd, cfg,
                                                 cache_dir=str(tmp_path)),
                                  want)
    cfg = cfg.replace(dataset="PortWrote")
    mine = apply_beltrami(pd, cfg, cache_dir=str(tmp_path))
    np.testing.assert_allclose(mine, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        gx_apply_beltrami(gd, gcfg.replace(dataset="PortWrote"),
                          cache_dir=str(tmp_path)), mine)
    emb = np.random.RandomState(1).randn(40, 8).astype(np.float32)
    path = os.path.join(tmp_path, "pos_encodings", "Toy_DW8.pkl")
    with open(path, "wb") as f:
        pickle.dump({"data": emb, "acc": 0.5}, f)
    for fn, c in ((apply_beltrami, Config), (gx_apply_beltrami, GxConfig)):
        got = fn(pd if fn is apply_beltrami else gd,
                 c(dataset="Toy", pos_enc_type="DW8"),
                 cache_dir=str(tmp_path))
        np.testing.assert_array_equal(got, emb)


def test_deepwalk_encodings_through_apply_beltrami(tmp_path):
    """``DW8`` computed by the port on the CPU: its shape, finite values,
    the probe's accuracy in the pickle, a second call read from it."""
    pd = make_sbm_dataset(num_nodes=40, num_classes=3, seed=4, device="cpu")
    cfg = Config(dataset="Toy", pos_enc_type="DW8")
    enc = apply_beltrami(pd, cfg, cache_dir=str(tmp_path))
    assert enc.shape == (40, 8) and np.isfinite(enc).all()
    with open(os.path.join(tmp_path, "pos_encodings", "Toy_DW8.pkl"),
              "rb") as f:
        obj = pickle.load(f)
    assert 0.0 <= obj["acc"] <= 1.0
    np.testing.assert_array_equal(apply_beltrami(pd, cfg,
                                                 cache_dir=str(tmp_path)),
                                  enc)


# ----------------------------------------------------------------------
# the kernels' plain versions in beltrami_exp against graphax's Pallas

def make_graphs(n=29, e=120, seed=0, pad=5):
    rng = np.random.RandomState(seed)
    row = rng.randint(0, n - 4, e)
    col = rng.randint(0, n - 4, e)
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    w = (rng.rand(e) + 0.2).astype(np.float32)
    gx = GxGraph.from_edges(row, col, n, edge_weight=w,
                            edge_buffer_size=e + pad)
    gx = dataclasses.replace(attach_tiles(gx, tile=8, block_edges=16),
                             strategy="tiled")
    pt = Graph.from_edges(row, col, n, edge_weight=w, edge_buffer_size=e + pad)
    return gx, pt


def beltrami_attention(gcfg, cfg, d, seed=1):
    """graphax's Beltrami attention tree with random Qx/Kx/Qp/Kp (0.3 randn
    weights, 0.1 randn biases) and scalars away from 1, and the port's
    layer loaded from it."""
    p = transformer_attention_init(jax.random.PRNGKey(0), gcfg, d)
    rng = np.random.RandomState(seed)
    for name in ("Qx", "Kx", "Qp", "Kp"):
        p[name] = {k: jnp.asarray(rng.randn(*p[name][k].shape) * s,
                                  jnp.float32)
                   for k, s in (("w", 0.3), ("b", 0.1))}
    for name, v in (("output_var_x", 1.2), ("lengthscale_x", 0.9),
                    ("output_var_p", 0.8), ("lengthscale_p", 1.3)):
        p[name] = jnp.asarray(v, jnp.float32)
    att = TransformerAttention(cfg, d)
    load_graphax_params(att, to_np(p))
    return p, att


def _cfgs(**kw):
    base = dict(BEL, function="transformer")
    base.update(kw)
    return GxConfig(**base), Config(**base)


@pytest.mark.parametrize("reweight", [False, True])
def test_pin_plain_beltrami_matches_pallas(reweight):
    gx, pt = make_graphs()
    gcfg, cfg = _cfgs(reweight_attention=reweight)
    p, att = beltrami_attention(gcfg, cfg, 9)
    x = np.random.RandomState(3).randn(29, 9).astype(np.float32)
    want = attention_edge_means_pallas(gcfg, p, gx.tiles, jnp.asarray(x),
                                       int(gx.edge_buffer_size),
                                       edge_weight=gx.edge_weight)
    with torch.no_grad():
        got = attention_edge_means(att, cfg, pt, torch.from_numpy(x),
                                   differentiable=False)
        ops = fa.prep_inputs(cfg, att, pt, torch.from_numpy(x))
    assert ops["att_type"] == "beltrami_exp" and ops["q"].shape == (29, 16)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL_PIN)
    assert np.all(got[pt.num_edges:].numpy() == 0)
    # the differentiable per-edge route gives the same pin
    edge = attention_edge_means(att, cfg, pt, torch.from_numpy(x),
                                differentiable=True)
    np.testing.assert_allclose(edge.detach().numpy(), _np(want), **TOL_PIN)


@pytest.mark.parametrize("square_plus", [False, True])
@pytest.mark.parametrize("reweight", [False, True])
def test_flash_plain_beltrami_matches_pallas(square_plus, reweight):
    gx, pt = make_graphs(seed=3)
    gcfg, cfg = _cfgs(square_plus=square_plus, reweight_attention=reweight)
    p, att = beltrami_attention(gcfg, cfg, 9, seed=2)
    x = np.random.RandomState(2).randn(gx.num_nodes, 9).astype(np.float32)
    want = fused_attention_ax_pallas(gcfg, p, gx.tiles, jnp.asarray(x),
                                     edge_weight=gx.edge_weight)
    with torch.no_grad():
        got = fa.flash_attention_ax(cfg, att, pt, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL_FLASH)
    assert np.all(got[-4:].numpy() == 0)


@pytest.mark.parametrize("reweight", [False, True])
def test_gmax_plain_beltrami_matches_pallas(reweight):
    gx, pt = make_graphs(seed=7)
    gcfg, cfg = _cfgs(square_plus=True, reweight_attention=reweight)
    p, att = beltrami_attention(gcfg, cfg, 9, seed=8)
    x = np.random.RandomState(9).randn(gx.num_nodes, 9).astype(np.float32)
    t = gx.tiles
    q_tiles, xg, wk, bk, wb, scal = _prep_inputs(
        gcfg, p, jnp.asarray(x), jnp.asarray(x), gx.edge_weight,
        t.edge_slot, t.slot_mask, t.col, t.num_tiles, t.tile)
    want = _gmax_call("beltrami_exp", reweight, gcfg.heads, q_tiles, xg, wk,
                      bk, wb, t.local_row, t.tile_idx, scal, t.num_tiles,
                      t.tile)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        ops = fa.prep_inputs(cfg, att, pt, xt)
        kt = fa.attention_kproj(xt, ops["wk"], ops["bk"])
        scal_p, bel = fa.score_args(ops)
        got = fa.attention_gmax(pt.csr, ops["q"], kt, ops["edge_w"], *scal_p,
                                **bel)
    np.testing.assert_allclose(float(got), float(want), **TOL_GMAX)


def test_beltrami_columns_interleave_heads():
    cols = fa.beltrami_columns(8, 2).tolist()
    assert cols == [0, 1, 2, 3, 8, 9, 10, 11, 4, 5, 6, 7, 12, 13, 14, 15]


def _off(t, offset):
    """``t``, or a contiguous copy of it one value past its storage's
    start (off every 16-byte boundary)."""
    if not offset:
        return t
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hk", [3, 4, 6, 8, 16])
@pytest.mark.parametrize("offset", [None, "q", "kt"])
def test_beltrami_vector_rule(dtype, hk, offset):
    """The host's 16-byte rule for beltrami_exp's instances, per half of a
    head's slice (hk = dk / 2 values, each half at its own offset): flash
    reads K by float4 where hk % 4 == 0 and the K table sits on 16 bytes
    (q from shared memory, whatever its dtype); gmax reads q and K so where
    a half of q fills whole 16-byte words and both tensors sit on 16
    bytes. scaled_dot keeps its rule over the whole slice."""
    heads, n = 2, 5
    a = 2 * hk * heads
    q = _off(torch.ones(n, a).to(dtype), offset == "q")
    kt = _off(torch.ones(n, a), offset == "kt")
    aligned = {"q": q.data_ptr() % 16 == 0, "kt": kt.data_ptr() % 16 == 0}
    assert aligned == {"q": offset != "q", "kt": offset != "kt"}
    want_gmax = int((hk * q.element_size()) % 16 == 0 and offset is None)
    want_flash = int(hk % 4 == 0 and offset != "kt")
    assert fa.score_vec(q, kt, heads, "beltrami_exp") == want_gmax
    assert fa.flash_kvec(kt, heads, "beltrami_exp") == want_flash
    # scaled_dot over the whole slice of 2 hk values, the other types none
    dk = 2 * hk
    assert fa.score_vec(q, kt, heads, "scaled_dot") == int(
        (dk * q.element_size()) % 16 == 0 and offset is None)
    assert fa.flash_kvec(kt, heads, "scaled_dot") == int(
        dk % 4 == 0 and offset != "kt")
    for other in ("exp_kernel", "cosine_sim", "pearson"):
        assert fa.score_vec(q, kt, heads, other) == 0
        assert fa.flash_kvec(kt, heads, other) == 0


def test_flash_warps_beltrami_stride():
    """beltrami_exp's flash instances round a warp's shared floats up to 4
    (every warp's q on 16 bytes): fewer warps fit where the rounding
    crosses the limit, and the other types keep the unrounded count."""
    for a, h in ((64, 2), (6, 3), (2045, 3), (11588, 1), (1696, 2)):
        floats = a + 2 * h + 32 * h
        padded = -(-floats // 4) * 4
        assert fa.flash_warps(a, h) == min(8, 232_448 // (4 * floats))
        assert fa.flash_warps(a, h, "beltrami_exp") == min(
            8, 232_448 // (4 * padded))
    assert fa.flash_warps(11588, 1, "beltrami_exp") == 4
    assert fa.flash_warps(11588, 1) == 5


def make_long_graphs(n=40, seed=12, pad=3):
    """make_graphs' pair with rows of 45 and 33 edges (more than one batch
    of the flash walk), a row of 32, short rows and the last rows empty."""
    rng = np.random.RandomState(seed)
    deg = np.r_[45, 0, 33, 32, rng.randint(0, 5, n - 8), 0, 0, 0, 0]
    row = np.repeat(np.arange(n), deg)
    col = rng.randint(0, n - 4, row.size)
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    w = (rng.rand(row.size) + 0.2).astype(np.float32)
    gx = GxGraph.from_edges(row, col, n, edge_weight=w,
                            edge_buffer_size=row.size + pad)
    gx = dataclasses.replace(attach_tiles(gx, tile=8, block_edges=16),
                             strategy="tiled")
    pt = Graph.from_edges(row, col, n, edge_weight=w,
                          edge_buffer_size=row.size + pad)
    return gx, pt


@pytest.mark.parametrize("square_plus,reweight", [(False, True),
                                                  (True, False)])
def test_flash_and_gmax_plain_beltrami_odd_half_long_rows(square_plus,
                                                          reweight):
    """flash and (under squareplus) gmax in beltrami_exp at a half of 3
    values a head (attention_dim 6, 2 heads: the instances' one-value
    route) on rows of up to 45 edges, against graphax's interpreted Pallas
    kernels."""
    gx, pt = make_long_graphs()
    gcfg, cfg = _cfgs(attention_dim=6, square_plus=square_plus,
                      reweight_attention=reweight)
    p, att = beltrami_attention(gcfg, cfg, 9, seed=5)
    x = np.random.RandomState(6).randn(gx.num_nodes, 9).astype(np.float32)
    xt = torch.from_numpy(x)
    want = fused_attention_ax_pallas(gcfg, p, gx.tiles, jnp.asarray(x),
                                     edge_weight=gx.edge_weight)
    with torch.no_grad():
        ops = fa.prep_inputs(cfg, att, pt, xt)
        got = fa.flash_attention_ax(cfg, att, pt, xt)
    assert ops["q"].shape == (40, 12) and fa.flash_kvec(
        ops["q"].float(), 2, "beltrami_exp") == 0
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL_FLASH)
    assert np.all(got[[1, -4, -3, -2, -1]].numpy() == 0)
    if not square_plus:
        return
    t = gx.tiles
    q_tiles, xg, wk, bk, wb, scal = _prep_inputs(
        gcfg, p, jnp.asarray(x), jnp.asarray(x), gx.edge_weight,
        t.edge_slot, t.slot_mask, t.col, t.num_tiles, t.tile)
    want = _gmax_call("beltrami_exp", reweight, gcfg.heads, q_tiles, xg, wk,
                      bk, wb, t.local_row, t.tile_idx, scal, t.num_tiles,
                      t.tile)
    with torch.no_grad():
        kt = fa.attention_kproj(xt, ops["wk"], ops["bk"])
        scal_p, bel = fa.score_args(ops)
        got = fa.attention_gmax(pt.csr, ops["q"], kt, ops["edge_w"], *scal_p,
                                **bel)
    np.testing.assert_allclose(float(got), float(want), **TOL_GMAX)


# ----------------------------------------------------------------------
# the model: encoder, attention, forward and a train step

def _pos(n=60, p=3, seed=4):
    return np.random.RandomState(seed).randn(n, p).astype(np.float32)


@pytest.mark.parametrize("block,att_type", [
    ("constant", "exp_kernel"), ("constant", "scaled_dot"),
    ("hard_attention", "exp_kernel")])
def test_beltrami_forward_matches_graphax(block, att_type):
    """The Beltrami encoder (mx and mp, ``[features | positional]``) and
    the solve: GRAND-nl's RHS (``constant``: the split score, or a
    scaled_dot score over the whole state) or the hard block's pin, with
    transplanted weights; logits to 1e-5, NFE equal."""
    over = dict(BEL, attention_type=att_type, block=block, hidden_dim=8,
                method="dopri5", time=1.5, input_dropout=0.0, dropout=0.0,
                batch_norm=False, use_mlp=True, dtype="float32",
                function="transformer" if block == "constant"
                else "laplacian")
    gcfg, cfg = GxConfig(**over), Config(**over)
    gd = gx_make_sbm(**SBM)
    gd = dataclasses.replace(gd, graph=dataclasses.replace(
        gd.graph, strategy="sparse")).with_pos_encoding(jnp.asarray(_pos()))
    pd = make_sbm_dataset(**SBM, strategy="sparse", device="cpu") \
        .with_pos_encoding(_pos())
    gm = make_gnn(gcfg, 8, 3)
    params, state = gm.init(jax.random.PRNGKey(0))
    blk = params["block"]
    att_tree = blk["att_layer"] if block == "hard_attention" \
        else blk["func"]["att"]
    rng = np.random.RandomState(6)
    for name in [k for k in att_tree if k[0] in "QK"]:
        att_tree[name] = {k: jnp.asarray(rng.randn(*att_tree[name][k].shape)
                                         * s, jnp.float32)
                          for k, s in (("w", 0.3), ("b", 0.1))}
    if block == "constant":
        blk["func"]["alpha_train"] = jnp.asarray(0.3)
    model = GNN(cfg, 8, 3)
    load_graphax_params(model, to_np(params), to_np(state))
    assert model.state_dim == 9 and model.mx.out_features == 5
    want, _, aux = gm.apply(params, state, gd.graph, gd.x, train=False,
                            pos_encoding=gd.pos_encoding)
    model.eval()
    with torch.no_grad():
        got, out = model(pd.graph, pd.x, train=False,
                         pos_encoding=pd.pos_encoding)
    assert out.result.nfe == int(aux["nfe"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGITS_ATOL)
    if block == "constant" and att_type == "exp_kernel":
        assert attention_route(cfg, pd.graph, 9) == "flash_replay"


@pytest.mark.parametrize("adjoint", [False, True])
def test_grand_nl_beltrami_train_step_matches_graphax(adjoint):
    """One GRAND-nl Beltrami train step (flash forward, the per-edge
    gradient replayed; autograd through the dopri5 steps, or the rk4
    adjoint with Qx/Kx/Qp/Kp and the four scalars in its state) from the
    same weights: the loss and every parameter's gradient (SGD at lr 1
    makes graphax's parameter change its gradient) within TOL_TRAIN,
    forward and backward NFE equal."""
    over = dict(BEL, block="constant", function="transformer", hidden_dim=8,
                method="dopri5", time=1.5, tol_scale=1000.0,
                adjoint=adjoint, adjoint_method="rk4", adjoint_step_size=0.5,
                input_dropout=0.0, dropout=0.0, batch_norm=False,
                optimizer="sgd", lr=1.0, decay=0.0, add_source=True,
                no_early=True, dtype="float32")
    gd = gx_make_sbm(**SBM)
    gd = dataclasses.replace(gd, graph=dataclasses.replace(
        gd.graph, strategy="sparse")).with_pos_encoding(jnp.asarray(_pos()))
    gtr = GxTrainer(GxConfig(**over), gd)
    st = gtr.init_state()
    fn = st.params["block"]["func"]
    rng = np.random.RandomState(8)
    for name in ("Qx", "Kx", "Qp", "Kp"):
        fn["att"][name] = {k: jnp.asarray(rng.randn(*fn["att"][name][k]
                                                    .shape) * s, jnp.float32)
                           for k, s in (("w", 0.3), ("b", 0.1))}
    fn["att"]["lengthscale_x"] = jnp.asarray(0.9)
    fn["alpha_train"] = jnp.asarray(0.3)
    fn["beta_train"] = jnp.asarray(-0.4)
    tr = Trainer(Config(**over), make_sbm_dataset(
        **SBM, strategy="sparse", device="cpu").with_pos_encoding(_pos()),
        device="cpu")
    assert attention_route(tr.cfg, tr.data.graph, 9) == "flash_replay"
    load_graphax_params(tr.model, to_np(st.params), to_np(st.model_state))
    before = graphax_to_state_dict(to_np(st.params), to_np(st.model_state))
    st, gx_loss = gtr.train_step(st)
    loss = tr.train_step()
    after = graphax_to_state_dict(to_np(st.params), to_np(st.model_state))
    np.testing.assert_allclose(loss, float(gx_loss), rtol=TOL_TRAIN["rtol"])
    assert tr.fm.get_value() == gtr.fm.get_value()
    assert tr.bm.get_value() == gtr.bm.get_value()
    grads = {k: p.grad.numpy() for k, p in tr.model.named_parameters()
             if p.grad is not None}
    assert {"block.func.att.Qx.weight", "block.func.att.Kp.bias",
            "block.func.att.output_var_p", "mx.weight",
            "mp.weight"} <= set(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g, before[k] - after[k], **TOL_TRAIN,
                                   err_msg=k)
