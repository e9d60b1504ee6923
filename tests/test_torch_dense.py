"""The dense strategy and GRAND-nl's dense route in the port against graphax,
on the CPU.

graphax's `tests/test_dense_path.py` oracles re-run against the port, and
the port against graphax's dense functions on the same graphs (duplicate
edges, rows without edges, padded buffers), inputs from numpy seeds and
weights through `load_graphax_params`:

- densify and the adjacency mask: exact (copies and sums of two values);
- masked softmax and squareplus, and the dense RHS and blocks against the
  edge-space path and graphax's dense route: f32 rtol 2e-4 / atol 1e-5
  (graphax's own tolerance between its dense and edge paths);
- one adjoint train step at the Computers (dopri5 adjoint) and Photo (rk4
  adjoint) presets at toy width: loss 1e-6, NFE and backward NFE equal,
  gradients 1e-4 relative / 1e-6 absolute (tests/test_torch_adjoint.py);
- the masked flash kernel's plain version against graphax's
  `flash_attention_multihead(..., interpret=True)`: with graphax's 512-key
  blocks f32 1e-5 / 1e-6 and bf16 one bf16 ulp (2^-7 relative, 1e-3
  absolute: the same rounding points, sums in another order); with the
  kernel's 64-key tiles f32 2e-4 / 2e-5 and bf16 2e-2 / 2e-2 (p rounded to
  bf16 against another running max);
- GRAND-nl's dense RHS with the K6 route forced through that plain version
  against graphax's `dense_rhs_ax` on the CPU (its materialised route): f32
  2e-4 / 2e-5, bf16 2e-2 / 2e-2 (the K6 route divides the summed products
  by max(l, 1e-16) where the materialised one divides each weight by its
  denominator + 1e-16, and takes a running max where it takes the row's);
- a GRAND-nl dense evaluation: logits 1e-4 with equal NFE; then a train
  step: loss 1e-4 relative, NFE equal."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.blocks import get_block as gx_get_block
from graphax.blocks.common import make_fstate as gx_make_fstate
from graphax.blocks.common import normalize_graph as gx_normalize_graph
from graphax.data.synthetic import make_sbm_dataset as gx_make_sbm
from graphax.functions import get_function as gx_get_function
from graphax.functions.common import FuncState as GxFuncState
from graphax.functions.transformer import dense_rhs_ax as gx_dense_rhs_ax
from graphax.kernels import dense_path as gx_dense
from graphax.kernels.pallas_ops import (
    flash_attention_multihead as gx_flash_multihead,
)
from graphax.sparse import Graph as GxGraph
from graphax.sparse import build as gx_build
from graphax.train import Config as GxConfig
from graphax.train.loop import Trainer as GxTrainer

from graphax_torch import Trainer, get_dataset, make_sbm_dataset
from graphax_torch.blocks import get_block
from graphax_torch.blocks.common import make_fstate, normalize_graph
from graphax_torch.functions import get_function
from graphax_torch.functions.common import prepare_scalars
from graphax_torch.functions.transformer import dense_rhs_ax
from graphax_torch.kernels import dense_path
from graphax_torch.kernels.flash_dense import (
    flash_attention_multihead, flash_attention_multihead_plain,
)
from graphax_torch.sparse import build
from graphax_torch.sparse.graph import Graph
from graphax_torch.sparse.ops import segment_softmax, squareplus_norm
from graphax_torch.train import Config, best_config
from graphax_torch.utils.transplant import (
    graphax_to_state_dict, load_graphax_params,
)

F32 = dict(rtol=2e-4, atol=1e-5)
ATT_TYPES = ["scaled_dot", "cosine_sim", "pearson", "exp_kernel"]
to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)


def graphs(n=120, e=600, seed=0, pad=32, loops=True):
    """The same edges in both packages, as graphax's test_dense_path builds
    them (undirected, self-loops), or with duplicate edges and rows without
    an edge (``loops=False``): graphax's dense graph, the port's dense and
    sparse graphs."""
    rng = np.random.RandomState(seed)
    row, col = rng.randint(0, n, e), rng.randint(0, n, e)
    if loops:
        keep = row != col
        r, c, w = gx_build.add_self_loops(
            *gx_build.to_undirected(row[keep], col[keep], n), None, 1.0, n)
    else:
        row, col = row % (n - 5), col % (n - 5)     # the last 5 rows empty
        row[:20], col[:20] = row[20:40], col[20:40]
        order = np.lexsort((col, row))
        r, c = row[order], col[order]
        w = (rng.rand(e) + 0.2).astype(np.float32)
    gx = dataclasses.replace(
        GxGraph.from_edges(r, c, n, w, edge_buffer_size=len(r) + pad),
        strategy="dense")
    sp = Graph.from_edges(r, c, n, w, edge_buffer_size=len(r) + pad)
    return gx, dataclasses.replace(sp, strategy="dense"), sp


def test_densify_matches_graphax():
    gx, pt, _ = graphs(seed=1, loops=False)
    want = np.asarray(gx_dense.densify(gx, gx.edge_weight))
    got = dense_path.densify(pt, pt.edge_weight).numpy()
    np.testing.assert_array_equal(got, want)
    e = pt.num_edges
    ref = np.zeros((pt.num_nodes,) * 2, np.float32)
    np.add.at(ref, (pt.row[:e].numpy(), pt.col[:e].numpy()),
              pt.edge_weight[:e].numpy())
    np.testing.assert_array_equal(got, ref)        # duplicates sum
    np.testing.assert_array_equal(
        dense_path.dense_adjacency_mask(pt).numpy(),
        np.asarray(gx_dense.dense_adjacency_mask(gx)))
    assert not dense_path.dense_adjacency_mask(pt)[-5:].any()


@pytest.mark.parametrize("norm", ["softmax", "squareplus"])
@pytest.mark.parametrize("axis", [1, 0])
def test_masked_norm_matches_segment_and_graphax(norm, axis):
    gx, pt, sp = graphs(seed=2)
    rng = np.random.RandomState(2)
    scores = rng.randn(pt.edge_buffer_size).astype(np.float32)
    dense_s = dense_path.densify(pt, torch.from_numpy(scores))
    mask = dense_path.dense_adjacency_mask(pt)
    fns = {"softmax": (dense_path.masked_softmax, gx_dense.masked_softmax,
                       segment_softmax),
           "squareplus": (dense_path.masked_squareplus,
                          gx_dense.masked_squareplus, squareplus_norm)}[norm]
    got = fns[0](dense_s, mask, axis)
    want = fns[1](jnp.asarray(dense_s.numpy()), jnp.asarray(mask.numpy()),
                  axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    index = sp.row if axis == 1 else sp.col
    seg = fns[2](torch.from_numpy(scores)[:, None], index, sp.num_nodes,
                 mask=sp.edge_mask)[:, 0]
    edge = dense_path.dense_edge_values(sp, got)
    np.testing.assert_allclose(edge.numpy(), seg.numpy(), **F32)
    assert np.all(edge[sp.num_edges:].numpy() == 0)


def test_laplacian_rhs_dense_vs_edge_and_graphax():
    cfg = Config(hidden_dim=8, function="laplacian", self_loop_weight=1.0,
                 add_source=True)
    gx, pt, sp = graphs(seed=3)
    gcfg = GxConfig(hidden_dim=8, function="laplacian", self_loop_weight=1.0,
                    add_source=True)
    func = get_function(cfg, 8)
    with torch.no_grad():
        func.alpha_train.fill_(0.3)
        func.beta_train.fill_(-0.4)
    x = torch.from_numpy(np.random.RandomState(3).randn(120, 8)
                         .astype(np.float32))
    alpha, beta = prepare_scalars(func, cfg, x.dtype)
    fs_d = make_fstate(normalize_graph(cfg, pt), x, train=False, cfg=cfg)
    fs_e = make_fstate(normalize_graph(cfg, sp), x, train=False, cfg=cfg)
    assert fs_d.dense is not None and fs_d.dense.shape == (120, 120)
    assert fs_e.dense is None
    with torch.no_grad():
        got = func.rhs(alpha, beta, fs_d, 0.0, x)
        edge = func.rhs(alpha, beta, fs_e, 0.0, x)
    np.testing.assert_allclose(got.numpy(), edge.numpy(), **F32)
    gfunc = gx_get_function(gcfg, 8)
    gparams = {"alpha_train": jnp.asarray(0.3), "beta_train":
               jnp.asarray(-0.4)}
    gfs = gx_make_fstate(gx_normalize_graph(gcfg, gx), jnp.asarray(x.numpy()))
    from graphax.functions.common import prepare_scalars as gx_prepare

    want = gfunc.rhs(gx_prepare(gparams, gcfg, jnp.float32), gfs, 0.0,
                     jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_matmul_matches_graphax(dtype):
    """The dense product in the state dtype with f32 sums, against graphax's
    ``matmul(a.astype(x.dtype), x, preferred_element_type=f32)``: f32 1e-5
    / 1e-6, bf16 one bf16 ulp (the same products, sums in another order)."""
    rng = np.random.RandomState(4)
    a = rng.rand(150, 150).astype(np.float32) * (rng.rand(150, 150) < 0.1)
    x = rng.randn(150, 24).astype(np.float32)
    jdt = jnp.dtype(dtype)
    xj = jnp.asarray(x).astype(jdt)
    want = jnp.matmul(jnp.asarray(a).astype(jdt), xj,
                      preferred_element_type=jnp.float32).astype(jdt)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))) \
        .to(getattr(torch, dtype))
    got = dense_path.dense_matmul(torch.from_numpy(a), xt)
    assert got.dtype == xt.dtype
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" \
        else dict(rtol=2 ** -7, atol=1e-3)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def _random_att(gcfg, cfg, d, seed):
    """graphax's transformer function params with random Q/K (0.3 randn
    weights, 0.1 randn biases), and the port's function loaded from them."""
    gfunc = gx_get_function(gcfg, d)
    params = gfunc.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    for name in ("Q", "K"):
        params["att"][name] = {
            "w": jnp.asarray(0.3 * rng.randn(d, gcfg.attention_dim),
                             jnp.float32),
            "b": jnp.asarray(0.1 * rng.randn(gcfg.attention_dim),
                             jnp.float32)}
    if gcfg.attention_type == "exp_kernel":
        params["att"]["output_var"] = jnp.asarray(1.3)
        params["att"]["lengthscale"] = jnp.asarray(0.8)
    params["alpha_train"] = jnp.asarray(0.3)
    func = get_function(cfg, d)
    load_graphax_params(func, to_np(params))
    return gfunc, params, func


@pytest.mark.parametrize("att_type", ATT_TYPES)
@pytest.mark.parametrize("norm_idx", [0, 1])
@pytest.mark.parametrize("square_plus", [False, True])
def test_transformer_rhs_dense_matches_graphax(att_type, norm_idx,
                                               square_plus):
    kw = dict(hidden_dim=8, function="transformer", heads=2, attention_dim=8,
              attention_type=att_type, attention_norm_idx=norm_idx,
              square_plus=square_plus, self_loop_weight=1.0)
    gx, pt, _ = graphs(seed=4)
    gfunc, params, func = _random_att(GxConfig(**kw), Config(**kw), 8, 4)
    x = np.random.RandomState(4).randn(120, 8).astype(np.float32)
    want = gfunc.rhs(params, GxFuncState(graph=gx, x0=jnp.asarray(x)), 0.0,
                     jnp.asarray(x))
    cfg = Config(**kw)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        fs = make_fstate(pt, xt, train=False, cfg=cfg)
        alpha, beta = prepare_scalars(func, cfg, xt.dtype)
        got = func.rhs(alpha, beta, fs, 0.0, xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("block", ["constant", "hard_attention"])
def test_block_forward_dense_vs_edge_and_graphax(block):
    kw = dict(hidden_dim=8, block=block, function="laplacian", heads=2,
              attention_dim=8, method="rk4", step_size=0.5, time=2.0,
              self_loop_weight=1.0, add_source=True)
    gx, pt, sp = graphs(seed=5)
    gblk = gx_get_block(GxConfig(**kw), 8)
    params = gblk.init(jax.random.PRNGKey(5))
    if block == "hard_attention":
        rng = np.random.RandomState(5)
        for name in ("Q", "K"):
            params["att_layer"][name]["w"] = jnp.asarray(
                0.4 * rng.randn(8, 8), jnp.float32)
    params["func"]["alpha_train"] = jnp.asarray(0.3)
    params["func"]["beta_train"] = jnp.asarray(-0.4)
    blk = get_block(Config(**kw), 8)
    load_graphax_params(blk, to_np(params))
    x = np.random.RandomState(5).randn(120, 8).astype(np.float32)
    want = gblk.forward(params, gx, jnp.asarray(x), train=False).z
    with torch.no_grad():
        got = blk(pt, torch.from_numpy(x), train=False).z
        edge = blk(sp, torch.from_numpy(x), train=False).z
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(got.numpy(), edge.numpy(), **F32)


def test_build_graph_auto_strategy():
    g_small = build.build_graph([0, 1], [1, 0], 10, self_loop_weight=1.0,
                                device="cpu")
    assert g_small.strategy == "dense"
    assert g_small.csr.num_slots == g_small.num_edges == 12
    rng = np.random.RandomState(0)
    n = 25_000
    g_big = build.build_graph(rng.randint(0, n, 1000),
                              rng.randint(0, n, 1000), n, device="cpu")
    assert g_big.strategy == "sparse"


@pytest.mark.parametrize("name", ["Computers", "Photo"])
def test_preset_stand_ins_are_dense(name):
    data = get_dataset(name, device="cpu")
    assert data.graph.strategy == "dense"
    assert data.num_nodes == {"Computers": 13381, "Photo": 7487}[name]


@pytest.mark.parametrize("name", ["Computers", "Photo"])
def test_preset_fits_with_its_defaults(name):
    """The preset as published (hard attention, dense strategy, adjoint,
    early-stop evaluation) on a small SBM: fit with no override."""
    data = make_sbm_dataset(num_nodes=150, num_classes=4, num_features=12,
                            seed=2, device="cpu")
    tr = Trainer(best_config(name), data, device="cpu")
    assert tr.data.graph.strategy == "dense" and not tr.cfg.no_early
    fit = tr.fit(epochs=1)
    s = fit["solver"][0]
    assert np.isfinite(fit["history"][0]["loss"])
    assert s["success"] and s["bwd_nfe"] > 0 and s["eval_nfe"] > s["nfe"]


def _preset_step(name):
    """One train step of ``name``'s preset at toy width (16 hidden, 2 heads
    of 4), no dropout, SGD with lr 1 (the parameter change is the
    gradient), on graphax's small SBM (the dense strategy in both)."""
    over = dict(hidden_dim=16, heads=2, attention_dim=8, input_dropout=0.0,
                dropout=0.0, optimizer="sgd", lr=1.0, decay=0.0)
    sbm = dict(num_nodes=200, num_classes=4, num_features=16, seed=3)
    gcfg = GxConfig.from_dict(
        {**dataclasses.asdict(best_config(name)), **over})
    gtr = GxTrainer(gcfg, gx_make_sbm(**sbm))
    state = gtr.init_state()
    params = state.params
    rng = np.random.RandomState(7)
    for k in ("Q", "K"):
        w = params["block"]["att_layer"][k]["w"]
        params["block"]["att_layer"][k]["w"] = jnp.asarray(
            0.4 * rng.randn(*w.shape), jnp.float32)
    params["block"]["func"]["alpha_train"] = jnp.asarray(0.3)
    state = state._replace(params=params)
    before = graphax_to_state_dict(to_np(state.params),
                                   to_np(state.model_state))
    tr = Trainer(best_config(name, **over),
                 make_sbm_dataset(**sbm, device="cpu"), device="cpu")
    assert tr.data.graph.strategy == gtr.data.graph.strategy == "dense"
    load_graphax_params(tr.model, to_np(state.params),
                        to_np(state.model_state))
    state, gx_loss = gtr.train_step(state)
    pt_loss = tr.train_step()
    after = graphax_to_state_dict(to_np(state.params),
                                  to_np(state.model_state))
    pt_grad = {k: p.grad.numpy() for k, p in tr.model.named_parameters()
               if p.grad is not None}
    return (gx_loss, gtr.fm.get_value(), gtr.bm.get_value(),
            {k: before[k] - after[k] for k in pt_grad},
            pt_loss, tr.fm.get_value(), tr.bm.get_value(), pt_grad)


@pytest.mark.parametrize("name", ["Computers", "Photo"])
def test_preset_adjoint_step_matches_graphax(name):
    (gx_loss, gx_nfe, gx_bwd, gx_grad,
     pt_loss, pt_nfe, pt_bwd, pt_grad) = _preset_step(name)
    np.testing.assert_allclose(pt_loss, float(gx_loss), rtol=1e-6)
    assert pt_nfe == gx_nfe
    assert pt_bwd == gx_bwd, (pt_bwd, gx_bwd)
    assert "block.func.alpha_train" in pt_grad
    for k, g in pt_grad.items():
        np.testing.assert_allclose(g, gx_grad[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def _flash_inputs(n, heads, dk, d, seed):
    """q, k, v and a mask with self-loops, a few random edges per row and
    the last 3 rows empty."""
    rng = np.random.RandomState(seed)
    q = (0.5 * rng.randn(n, heads, dk)).astype(np.float32)
    k = (0.5 * rng.randn(n, heads, dk)).astype(np.float32)
    v = rng.randn(n, d).astype(np.float32)
    mask = rng.rand(n, n) < 6.0 / n
    mask[np.arange(n), np.arange(n)] = True
    mask[-3:] = False
    return q, k, v, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [300, 700])
def test_flash_dense_plain_matches_pallas(dtype, n):
    q, k, v, mask = _flash_inputs(n, 2, 4, 8, seed=n)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(gx_flash_multihead(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v).astype(jdt),
        jnp.asarray(mask), interpret=True).astype(jnp.float32))
    args = (torch.from_numpy(q), torch.from_numpy(k),
            torch.from_numpy(v).to(tdt), torch.from_numpy(mask))
    same_blocks = flash_attention_multihead_plain(*args, block_k=512)
    with torch.no_grad():
        got = flash_attention_multihead(*args)    # CPU: the plain version
    assert got.dtype == tdt and got.shape == (2, n, 8)
    np.testing.assert_array_equal(got[:, -3:].float().numpy(), 0.0)
    if dtype == "float32":
        np.testing.assert_allclose(same_blocks.numpy(), want, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    else:
        np.testing.assert_allclose(same_blocks.float().numpy(), want,
                                   rtol=2.0 ** -7, atol=1e-3)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grand_nl_dense_rhs_k6_route_matches_graphax(dtype):
    kw = dict(hidden_dim=8, function="transformer", heads=2, attention_dim=8,
              self_loop_weight=1.0)
    gx, pt, _ = graphs(n=200, e=900, seed=6, loops=False)
    gcfg, cfg = GxConfig(**kw), Config(**kw)
    _, params, func = _random_att(gcfg, cfg, 8, 6)
    x = np.random.RandomState(6).randn(200, 8).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(gx_dense_rhs_ax(params["att"], gcfg, gx,
                                      jnp.asarray(x).astype(jdt))
                      .astype(jnp.float32))
    xt = torch.from_numpy(x).to(tdt)
    with torch.no_grad():
        k6 = dense_rhs_ax(func.att, cfg, pt, xt, use_flash=True)
        mat = dense_rhs_ax(func.att, cfg, pt, xt, use_flash=False)
    assert k6.dtype == tdt and k6.shape == (200, 8)
    tol = F32 if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(k6.float().numpy(), want, **tol)
    np.testing.assert_allclose(mat.float().numpy(), want, **tol)
    np.testing.assert_array_equal(k6[-5:].float().numpy(), 0.0)


def test_grand_nl_dense_evaluation_matches_graphax():
    kw = dict(dataset="sbm", block="constant", function="transformer",
              hidden_dim=16, heads=2, attention_dim=8, method="dopri5",
              tol_scale=1e3, time=2.0, input_dropout=0.0, dropout=0.0,
              add_source=True, no_early=True)
    sbm = dict(num_nodes=200, num_classes=4, num_features=16, seed=3)
    gtr = GxTrainer(GxConfig(**kw), gx_make_sbm(**sbm))
    state = gtr.init_state()
    att = state.params["block"]["func"]["att"]
    rng = np.random.RandomState(8)
    for name in ("Q", "K"):
        att[name] = {k: jnp.asarray(s * rng.randn(*att[name][k].shape),
                                    jnp.float32)
                     for k, s in (("w", 0.3), ("b", 0.1))}
    tr = Trainer(Config(**kw), make_sbm_dataset(**sbm, device="cpu"),
                 device="cpu")
    assert tr.data.graph.strategy == "dense"
    load_graphax_params(tr.model, to_np(state.params),
                        to_np(state.model_state))
    want, _, aux = gtr.model.apply(state.params, state.model_state,
                                   gtr.data.graph, gtr.data.x, train=False)
    tr.model.eval()
    with torch.no_grad():
        got, out = tr.model(tr.data.graph, tr.data.x, train=False)
    assert out.result.nfe == int(aux["nfe"]) > 8
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    # a train step, which raised here before the dense route's gradient
    # was ported: graphax's loss (1e-4 relative) and NFE
    state, gx_loss = gtr.train_step(state)
    loss = tr.train_step()
    np.testing.assert_allclose(loss, float(gx_loss), rtol=1e-4)
    assert (tr.fm.get_value(), tr.bm.get_value()) \
        == (gtr.fm.get_value(), gtr.bm.get_value())
