"""GRAND-nl's evaluation forward and its training in the port against
graphax, on the CPU.

The port's wrappers run their plain versions here; graphax runs its Pallas
flash and gmax kernels in interpret mode (as tests/test_pallas_attention.py
does) on row-tiled graphs of tile 8 and 16-slot blocks, with duplicate
edges, rows without edges and padded edge buffers. Inputs come from numpy
seeds; weights go through `load_graphax_params`.

Tolerances:
- f32: rtol 2e-4 / atol 2e-5 (graphax's own, tests/test_pallas_attention.py),
  logits of the whole evaluation 1e-4 with equal NFE.
- bf16 kernel level: the port rounds ``e = exp(s - final row max)`` to bf16
  where graphax's online recurrence rounds ``exp(s - running max)`` and
  rescales in f32, so the weights differ by a bf16 rounding and outputs by
  a few: 2e-2 relative, 2e-2 absolute on outputs of size ~1 (7.8e-3 seen).
- bf16 evaluation: graphax's CPU route is its XLA block path
  (`graphax/kernels/fused_attention.py:145-224`), which rounds k to bf16
  and shifts by the global max; logits agree to 1e-2 absolute (3.0e-3
  seen on logits of size ~0.5), NFE within one dopri5 step (6; equal
  seen) (ROADMAP Queue 3).
- Training, f32: the training forward, its residuals and the gradients of
  x, Q and K against graphax's interpreted Pallas forward with residuals
  and backward (B1/B2/B3) at rtol 2e-4 / atol 2e-5, graphax's own.
- Training, bf16: outputs 2e-2 relative / 2e-2 absolute (a rounded weight
  at the margin moves a sum by one bf16 ulp: 1.6e-2 seen on outputs of
  size 2-4 over four seeds); gradients 5e-2 relative / 5e-2 absolute
  (seen: x 3.1e-2 on values of size ~3, two bf16 ulps; K's weight 1.0e-2
  of ~4, Q's 7e-7): graphax's B3 rounds k to bf16 (`:1242`) where the
  port's column kernel reads the f32 K table, and the port rounds the x
  cotangent's three terms to bf16 one by one where graphax sums two of
  them first (ROADMAP Queue 3)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.blocks.common import make_fstate as gx_make_fstate
from graphax.data.synthetic import make_sbm_dataset as gx_make_sbm
from graphax.functions import get_function as gx_get_function
from graphax.functions.common import prepare_scalars as gx_prepare_scalars
from graphax.functions.transformer import (
    multiply_attention as gx_multiply_attention,
    transformer_attention_apply as gx_attention_apply,
    transformer_attention_init,
)
from graphax.kernels import pallas_tiled
from graphax.kernels.dispatch import attach_tiles
from graphax.kernels.pallas_attention import (
    NEG, _gmax_call, _norm_call, _prep_inputs, _scores_call,
    fused_attention_ax_pallas,
)
from graphax.kernels.pallas_tiled import presence_scale
from graphax.models.gnn import make_gnn
from graphax.sparse import Graph as GxGraph
from graphax.train import Config as GxConfig

from graphax_torch import Trainer, make_sbm_dataset
from graphax_torch.blocks.common import make_fstate
from graphax_torch.functions import get_function
from graphax_torch.functions.common import prepare_scalars
from graphax_torch.functions.transformer import (
    TransformerAttention, attention_route, multiply_attention,
    transformer_attention_apply,
)
from graphax_torch.kernels import fused_attention as fa
from graphax_torch.models import GNN
from graphax_torch.sparse.graph import Graph
from graphax_torch.train import Config
from graphax_torch.utils.transplant import load_graphax_params

ATT_TYPES = ["scaled_dot", "cosine_sim", "pearson", "exp_kernel"]
F32 = dict(rtol=2e-4, atol=2e-5)


def make_graphs(n=29, e=120, seed=0, pad=5):
    """The same edges in both packages: the last 4 nodes own no edge, 12
    edges are duplicates, the buffer has ``pad`` padded slots."""
    rng = np.random.RandomState(seed)
    row = rng.randint(0, n - 4, e)
    col = rng.randint(0, n - 4, e)
    row[:12], col[:12] = row[12:24], col[12:24]
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    w = (rng.rand(e) + 0.2).astype(np.float32)
    gx = GxGraph.from_edges(row, col, n, edge_weight=w,
                            edge_buffer_size=e + pad)
    gx = dataclasses.replace(attach_tiles(gx, tile=8, block_edges=16),
                             strategy="tiled")
    pt = Graph.from_edges(row, col, n, edge_weight=w, edge_buffer_size=e + pad)
    return gx, pt


def _cfgs(**kw):
    base = dict(function="transformer", heads=2, attention_dim=8)
    base.update(kw)
    return GxConfig(**base), Config(**base)


def random_attention(gcfg, cfg, d, seed=1):
    """graphax's attention tree with random Q/K at graphax's test scale
    (0.3 randn weights, 0.1 randn biases), and the port's layer loaded from
    it."""
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


# ----------------------------------------------------------------------
# the kernels' plain versions against graphax's interpreted Pallas kernels
# ----------------------------------------------------------------------

@pytest.mark.parametrize("att_type", ATT_TYPES)
@pytest.mark.parametrize("square_plus", [False, True])
@pytest.mark.parametrize("reweight", [False, True])
def test_flash_matches_pallas(att_type, square_plus, reweight):
    gx, pt = make_graphs(seed=3)
    d = 6
    gcfg, cfg = _cfgs(hidden_dim=d, attention_type=att_type,
                      square_plus=square_plus, reweight_attention=reweight)
    p, att = random_attention(gcfg, cfg, d)
    x = np.random.RandomState(2).randn(gx.num_nodes, d).astype(np.float32)
    want = fused_attention_ax_pallas(gcfg, p, gx.tiles, jnp.asarray(x),
                                     edge_weight=gx.edge_weight)
    with torch.no_grad():
        got = fa.flash_attention_ax(cfg, att, pt, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    assert np.all(got[-4:].numpy() == 0)          # rows with no edge


@pytest.mark.parametrize("att_type,square_plus", [
    ("scaled_dot", False), ("pearson", False), ("exp_kernel", True)])
def test_flash_bf16_tracks_pallas(att_type, square_plus):
    gx, pt = make_graphs(seed=4)
    d = 6
    gcfg, cfg = _cfgs(hidden_dim=d, attention_type=att_type,
                      square_plus=square_plus, reweight_attention=True)
    p, att = random_attention(gcfg, cfg, d, seed=5)
    x = np.random.RandomState(6).randn(gx.num_nodes, d).astype(np.float32)
    want = fused_attention_ax_pallas(gcfg, p, gx.tiles,
                                     jnp.asarray(x).astype(jnp.bfloat16),
                                     edge_weight=gx.edge_weight)
    with torch.no_grad():
        got = fa.flash_attention_ax(cfg, att, pt,
                                    torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("att_type", ATT_TYPES)
@pytest.mark.parametrize("reweight", [False, True])
def test_gmax_matches_pallas(att_type, reweight):
    gx, pt = make_graphs(seed=7)
    d = 5
    gcfg, cfg = _cfgs(hidden_dim=d, attention_type=att_type, square_plus=True,
                      reweight_attention=reweight)
    p, att = random_attention(gcfg, cfg, d, seed=8)
    x = np.random.RandomState(9).randn(gx.num_nodes, d).astype(np.float32)
    t = gx.tiles
    q_tiles, xg, wk, bk, wb, scal = _prep_inputs(
        gcfg, p, jnp.asarray(x), jnp.asarray(x), gx.edge_weight,
        t.edge_slot, t.slot_mask, t.col, t.num_tiles, t.tile)
    want = _gmax_call(att_type, reweight, gcfg.heads, q_tiles, xg, wk, bk, wb,
                      t.local_row, t.tile_idx, scal, t.num_tiles, t.tile)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        ops = fa.prep_inputs(cfg, att, pt, xt)
        kt = fa.attention_kproj(xt, ops["wk"], ops["bk"])
        got = fa.attention_gmax(pt.csr, ops["q"], kt, ops["edge_w"],
                                att_type, cfg.heads, ops["ov2"],
                                ops["inv2l2"])
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), **F32)


def test_gmax_of_a_graph_without_edges_is_zero():
    pt = Graph.from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64), 5,
                          edge_buffer_size=3)
    q = torch.randn(5, 4)
    got = fa.attention_gmax(pt.csr, q, torch.randn(5, 4), None, "scaled_dot",
                            2)
    assert float(got) == 0.0
    out = fa.flash_attention(pt.csr, q, torch.randn(5, 3), torch.randn(5, 4),
                             None, None, "scaled_dot", 2)
    assert torch.equal(out, torch.zeros(5, 3))


def test_kproj_matches_the_projection_graphax_gathers():
    rng = np.random.RandomState(10)
    x = rng.randn(17, 9).astype(np.float32)
    wk = rng.randn(9, 8).astype(np.float32)
    bk = rng.randn(8).astype(np.float32)
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                         (torch.bfloat16, jnp.bfloat16, 1e-5)):
        got = fa.attention_kproj(torch.from_numpy(x).to(dt),
                                 torch.from_numpy(wk).to(dt),
                                 torch.from_numpy(bk))
        want = jax.lax.dot_general(
            jnp.asarray(x).astype(jdt), jnp.asarray(wk).astype(jdt),
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32) + jnp.asarray(bk)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=tol,
                                   atol=tol)


# ----------------------------------------------------------------------
# the plain per-edge path
# ----------------------------------------------------------------------

@pytest.mark.parametrize("att_type", ATT_TYPES)
@pytest.mark.parametrize("square_plus", [False, True])
@pytest.mark.parametrize("norm_idx", [0, 1])
def test_attention_apply_matches_graphax(att_type, square_plus, norm_idx):
    gx, pt = make_graphs(seed=11)
    d = 6
    for reweight in (False, True):
        gcfg, cfg = _cfgs(hidden_dim=d, attention_type=att_type,
                          square_plus=square_plus, attention_norm_idx=norm_idx,
                          reweight_attention=reweight)
        p, att = random_attention(gcfg, cfg, d, seed=12)
        x = np.random.RandomState(13).randn(gx.num_nodes, d) \
            .astype(np.float32)
        want, (wv, wprods) = gx_attention_apply(p, gcfg, gx, jnp.asarray(x))
        want_ax = gx_multiply_attention(p, gcfg, gx, jnp.asarray(x), want, wv)
        xt = torch.from_numpy(x)
        with torch.no_grad():
            got, (v, prods) = transformer_attention_apply(att, cfg, pt, xt)
            got_ax = multiply_attention(att, cfg, pt, xt, got, v)
        e = pt.num_edges
        np.testing.assert_allclose(prods[:e].numpy(), _np(wprods)[:e], **F32)
        np.testing.assert_allclose(got.numpy(), _np(want), **F32)
        np.testing.assert_allclose(v.numpy(), _np(wv), **F32)
        np.testing.assert_allclose(got_ax.numpy(), _np(want_ax), **F32)
        assert np.all(got[e:].numpy() == 0)


# ----------------------------------------------------------------------
# the RHS and the slice
# ----------------------------------------------------------------------

@pytest.mark.parametrize("att_type,square_plus,add_source", [
    ("scaled_dot", False, False), ("scaled_dot", False, True),
    ("cosine_sim", True, True)])
def test_rhs_matches_graphax_fast_route(monkeypatch, att_type, square_plus,
                                        add_source):
    """graphax's RHS under an eval fstate with FORCE (its Pallas flash,
    interpreted) against the port's."""
    monkeypatch.setattr(pallas_tiled, "FORCE", True)
    gx, pt = make_graphs(seed=14)
    d = 6
    gcfg, cfg = _cfgs(hidden_dim=d, attention_type=att_type,
                      square_plus=square_plus, add_source=add_source)
    f = gx_get_function(gcfg, d)
    params = f.init(jax.random.PRNGKey(1))
    params["att"], _ = random_attention(gcfg, cfg, d, seed=15)
    params["alpha_train"] = jnp.asarray(0.4)
    params["beta_train"] = jnp.asarray(-0.3)
    x = np.random.RandomState(16).randn(gx.num_nodes, d).astype(np.float32)
    fs = gx_make_fstate(gx, jnp.asarray(x), train=False, cfg=gcfg)
    assert fs.fast_attention
    want = f.rhs(gx_prepare_scalars(params, gcfg, jnp.float32), fs, 0.0,
                 jnp.asarray(x))

    func = get_function(cfg, d)
    load_graphax_params(func, jax.tree_util.tree_map(np.asarray, params))
    xt = torch.from_numpy(x)
    assert attention_route(cfg, pt, d) == ("flash" if att_type == "scaled_dot"
                                           else "flash_replay")
    with torch.no_grad():
        fst = make_fstate(pt, xt, train=False)
        alpha, beta = prepare_scalars(func, cfg, xt.dtype)
        got = func.rhs(alpha, beta, fst, 0.0, xt)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


SLICE = dict(dataset="sbm", block="constant", function="transformer",
             hidden_dim=16, heads=2, attention_dim=8,
             attention_type="scaled_dot", method="dopri5",
             tol_scale=11353.558848254957, time=3.6760155951687636,
             batch_norm=True, input_dropout=0.0, dropout=0.0, max_nfe=500,
             no_early=True)


def eval_both(dtype: str, **over):
    kw = dict(SLICE, dtype=dtype, **over)
    gcfg, cfg = GxConfig(**kw), Config(**kw)
    gdata = gx_make_sbm(num_nodes=400, num_classes=4, num_features=32, seed=0)
    graph = dataclasses.replace(attach_tiles(gdata.graph), strategy="tiled")
    model = make_gnn(gcfg, gdata.num_features, gdata.num_classes)
    params, state = model.init(jax.random.PRNGKey(3))
    params["block"]["func"]["att"], _ = random_attention(
        gcfg, cfg, model.state_dim, seed=17)
    params["block"]["func"]["alpha_train"] = jnp.asarray(0.7)
    logits, _, aux = model.apply(params, state, graph, gdata.x, train=False)

    data = make_sbm_dataset(num_nodes=400, num_classes=4, num_features=32,
                            seed=0, strategy="sparse", device="cpu")
    net = GNN(cfg, data.num_features, data.num_classes)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    load_graphax_params(net, to_np(params), to_np(state))
    net.eval()
    with torch.no_grad():
        got, out = net(data.graph, data.x, train=False)
    return got.numpy(), _np(logits), out.result, aux


def test_f32_eval_logits_and_nfe_match():
    got, want, res, aux = eval_both("float32")
    assert res.success and bool(aux["success"])
    assert res.nfe == int(aux["nfe"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_f32_eval_squareplus_reweight_matches():
    got, want, res, aux = eval_both("float32", square_plus=True,
                                    reweight_attention=True,
                                    attention_type="cosine_sim",
                                    add_source=True)
    assert res.nfe == int(aux["nfe"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bf16_eval_tracks_graphax():
    got, want, res, aux = eval_both("bfloat16")
    assert res.success
    assert abs(res.nfe - int(aux["nfe"])) <= 6, (res.nfe, aux["nfe"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)


def test_eval_launch_count_is_the_nfe(monkeypatch):
    """One flash evaluation per solver NFE (the card's counter counts the
    same calls)."""
    calls = []
    real = fa.flash_attention

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(fa, "flash_attention", counting)
    data = make_sbm_dataset(num_nodes=120, num_features=8, seed=2,
                            strategy="sparse", device="cpu")
    cfg = Config(**dict(SLICE, hidden_dim=8))
    net = GNN(cfg, data.num_features, data.num_classes)
    net.reset_parameters(torch.Generator().manual_seed(0))
    net.eval()
    with torch.no_grad():
        _, out = net(data.graph, data.x, train=False)
    assert len(calls) == out.result.nfe > 0


# ----------------------------------------------------------------------
# training: the forward with residuals and the backward
# ----------------------------------------------------------------------

TRAIN_TOL = {"float32": F32, "bfloat16": dict(rtol=2e-2, atol=2e-2)}
GRAD_TOL = {"float32": F32, "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _pallas_residuals(gcfg, p, gx, xj):
    """graphax's K1/K2 outputs as the custom VJP keeps them (`:1070-1085`),
    in the port's layout: scores [E, H] in edge order, shift and denom
    [N, H] per node."""
    t = gx.tiles
    q_tiles, xg, wk, bk, wb, scal = _prep_inputs(
        gcfg, p, xj, xj, gx.edge_weight, t.edge_slot, t.slot_mask, t.col,
        t.num_tiles, t.tile)
    scores, rmax = _scores_call("scaled_dot", False, gcfg.heads, q_tiles, xg,
                                wk, bk, wb, t.local_row, t.tile_idx, scal,
                                t.num_tiles, t.tile)
    present = presence_scale(t.tile_idx, t.num_tiles) > 0
    rmax = jnp.where(present[:, None, None], rmax, NEG)
    shift = jnp.where(rmax <= NEG / 2, 0.0, rmax)
    _, denom = _norm_call(False, scores, shift, t.local_row, t.tile_idx,
                          t.num_tiles, t.tile)
    h, n = gcfg.heads, gx.num_nodes
    node = lambda a: _np(jnp.transpose(a, (0, 2, 1)).reshape(-1, h))[:n]
    flat = _np(jnp.moveaxis(scores, 1, 2).reshape(-1, h))
    keep = np.asarray(t.slot_mask).reshape(-1)
    sc = np.zeros((gx.num_edges, h), np.float32)
    sc[np.asarray(t.edge_slot).reshape(-1)[keep]] = flat[keep]
    return sc, node(shift), node(denom)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_forward_and_residuals_match_pallas(dtype):
    """The residual forward's output against graphax's custom-VJP forward
    (under jax.vjp: K1/K2/K3, not flash), its residuals against K1/K2's."""
    gx, pt = make_graphs(seed=20)
    d = 6
    gcfg, cfg = _cfgs(hidden_dim=d)
    p, att = random_attention(gcfg, cfg, d, seed=21)
    x = np.random.RandomState(22).randn(gx.num_nodes, d).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    want, _ = jax.vjp(lambda xx: fused_attention_ax_pallas(
        gcfg, p, gx.tiles, xx, edge_weight=gx.edge_weight,
        tiles_t=gx.tiles_t), xj)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    with torch.no_grad():
        ops = fa.prep_inputs(cfg, att, pt, xt)
        kt = fa.attention_kproj(xt, ops["wk"], ops["bk"])
        got, sc, shift, denom = fa.attention_fwd_res(pt.csr, ops["q"], xt, kt,
                                                     cfg.heads)
    assert got.dtype == xt.dtype and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               **TRAIN_TOL[dtype])
    assert np.all(got[-4:].float().numpy() == 0)
    assert np.all(shift[-4:].numpy() == 0) and np.all(denom[-4:].numpy() == 0)
    if dtype == "float32":
        w_sc, w_shift, w_denom = _pallas_residuals(gcfg, p, gx, xj)
        np.testing.assert_allclose(sc.numpy(), w_sc, **F32)
        np.testing.assert_allclose(shift.numpy(), w_shift, **F32)
        np.testing.assert_allclose(denom.numpy(), w_denom, **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_gradients_match_pallas_backward(dtype):
    """The gradients of x, Q and K through the port's autograd Functions
    against jax.grad through graphax's Pallas backward (B1/B2/B3)."""
    gx, pt = make_graphs(seed=23)
    d = 6
    gcfg, cfg = _cfgs(hidden_dim=d)
    p, att = random_attention(gcfg, cfg, d, seed=24)
    rng = np.random.RandomState(25)
    x = rng.randn(gx.num_nodes, d).astype(np.float32)
    probe = rng.randn(gx.num_nodes, d).astype(np.float32)

    def loss(pp, xx):
        out = fused_attention_ax_pallas(gcfg, pp, gx.tiles, xx,
                                        edge_weight=gx.edge_weight,
                                        tiles_t=gx.tiles_t)
        return jnp.sum(out.astype(jnp.float32) * probe)

    gp, gxx = jax.grad(loss, argnums=(0, 1))(
        p, jnp.asarray(x).astype(jnp.dtype(dtype)))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    out = fa.fused_attention_ax(cfg, att, pt, xt)
    (out.float() * torch.from_numpy(probe)).sum().backward()
    tol = GRAD_TOL[dtype]
    np.testing.assert_allclose(xt.grad.float().numpy(), _np(gxx), **tol)
    for name in ("Q", "K"):
        lin = getattr(att, name)
        np.testing.assert_allclose(lin.weight.grad.numpy(),
                                   _np(gp[name]["w"]).T, err_msg=name, **tol)
        np.testing.assert_allclose(lin.bias.grad.numpy(), _np(gp[name]["b"]),
                                   err_msg=name, **tol)
    assert att.V.weight.grad is None and att.Wout.weight.grad is None


def test_train_rhs_matches_graphax_train_route(monkeypatch):
    """graphax's RHS under a train fstate with FORCE (fast_attention: its
    Pallas forward with residuals and backward, interpreted) against the
    port's training route: the value and the gradients of x, alpha, beta,
    Q and K."""
    monkeypatch.setattr(pallas_tiled, "FORCE", True)
    gx, pt = make_graphs(seed=26)
    d = 6
    gcfg, cfg = _cfgs(hidden_dim=d, add_source=True)
    f = gx_get_function(gcfg, d)
    params = f.init(jax.random.PRNGKey(1))
    params["att"], _ = random_attention(gcfg, cfg, d, seed=27)
    params["alpha_train"] = jnp.asarray(0.4)
    params["beta_train"] = jnp.asarray(-0.3)
    rng = np.random.RandomState(28)
    x = rng.randn(gx.num_nodes, d).astype(np.float32)
    probe = rng.randn(gx.num_nodes, d).astype(np.float32)
    fs = gx_make_fstate(gx, jnp.asarray(x), train=True, cfg=gcfg)
    assert fs.fast_attention

    def loss(pp, xx):
        return jnp.sum(f.rhs(gx_prepare_scalars(pp, gcfg, jnp.float32), fs,
                             0.0, xx) * probe)

    want = f.rhs(gx_prepare_scalars(params, gcfg, jnp.float32), fs, 0.0,
                 jnp.asarray(x))
    gp, gxx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    func = get_function(cfg, d)
    load_graphax_params(func, jax.tree_util.tree_map(np.asarray, params))
    xt = torch.from_numpy(x).requires_grad_(True)
    fst = make_fstate(pt, xt, train=True, cfg=cfg)
    assert attention_route(cfg, pt, d) == "flash"
    assert attention_route(cfg.replace(square_plus=True), pt,
                           d) == "flash_replay"
    alpha, beta = prepare_scalars(func, cfg, xt.dtype)
    got = func.rhs(alpha, beta, fst, 0.0, xt)
    (got * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **F32)
    np.testing.assert_allclose(xt.grad.numpy(), _np(gxx), **F32)
    for k in ("alpha_train", "beta_train"):
        np.testing.assert_allclose(float(getattr(func, k).grad),
                                   float(gp[k]), err_msg=k, **F32)
    for name in ("Q", "K"):
        lin = getattr(func.att, name)
        np.testing.assert_allclose(lin.weight.grad.numpy(),
                                   _np(gp["att"][name]["w"]).T, err_msg=name,
                                   **F32)
        np.testing.assert_allclose(lin.bias.grad.numpy(),
                                   _np(gp["att"][name]["b"]), err_msg=name,
                                   **F32)


# ----------------------------------------------------------------------
# training, and what raises
# ----------------------------------------------------------------------

def _small_trainer(**over):
    data = make_sbm_dataset(num_nodes=60, num_classes=3, num_features=8,
                            seed=1, strategy="sparse", device="cpu")
    cfg = Config(**dict(SLICE, hidden_dim=8, **over))
    return Trainer(cfg, data, device="cpu")


def _train_trainer(adjoint: bool, **over):
    tr = _small_trainer(adjoint=adjoint, adjoint_method="rk4", lr=0.05,
                        **over)
    gen = torch.Generator().manual_seed(3)
    att = tr.model.block.func.att
    with torch.no_grad():
        for lin in (att.Q, att.K):
            lin.weight.copy_(0.3 * torch.randn(lin.weight.shape,
                                               generator=gen))
            lin.bias.copy_(0.1 * torch.randn(lin.bias.shape, generator=gen))
    return tr


@pytest.mark.parametrize("adjoint", [False, True])
def test_training_steps(monkeypatch, adjoint):
    """Three train steps: finite, decreasing loss, gradients at Q and K;
    under the adjoint each training kernel once per backward NFE (flash
    serves the forward solve)."""
    calls = {}
    for name in ("attention_fwd_res", "attention_bwd_rows",
                 "attention_bwd_cols", "flash_attention"):
        real = getattr(fa, name)

        def counting(*a, _real=real, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(fa, name, counting)
    tr = _train_trainer(adjoint)
    losses = []
    for _ in range(3):
        calls.clear()
        losses.append(tr.train_step())
        if adjoint:
            nfe, bwd = tr.fm.get_value(), tr.bm.get_value()
            assert calls == {"flash_attention": nfe, "attention_fwd_res": bwd,
                             "attention_bwd_rows": bwd,
                             "attention_bwd_cols": bwd}, calls
    assert all(np.isfinite(losses)) and losses[0] > losses[1] > losses[2]
    att = tr.model.block.func.att
    for lin in (att.Q, att.K):
        assert float(lin.weight.grad.abs().max()) > 0
    assert att.V.weight.grad is None or not att.V.weight.grad.any()


@pytest.mark.parametrize("adjoint", [False, True])
def test_training_raises(monkeypatch, adjoint):
    """Row-normalised training configs on CSR outside the hand-written
    backward once raised here; they now train and match graphax's step
    (with batch norm; tests/test_torch_grand_nl_train.py holds the rest),
    through the flash kernel once per forward NFE, and once per adjoint
    NFE under the adjoint (the replay's forward), with no training
    kernel. Column normalisation trains (its route's backward replays
    the plain per-edge path, as graphax's custom VJP does)."""
    from test_torch_grand_nl_train import one_step

    calls = {}
    for name in ("flash_attention", "attention_fwd_res"):
        real = getattr(fa, name)

        def counting(*a, _real=real, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(fa, name, counting)
    for over in (dict(square_plus=True), dict(attention_type="cosine_sim"),
                 dict(reweight_attention=True)):
        calls.clear()
        tr = one_step("sparse", "flash_replay", adjoint=adjoint,
                      batch_norm=True, **over)
        want = tr.fm.get_value() + (tr.bm.get_value() if adjoint else 0)
        evals = calls.pop("flash_attention") - want
        assert calls == {} and evals == (0 if adjoint
                                         else tr.last_eval.nfe), calls
    tr = _train_trainer(adjoint, attention_norm_idx=1)
    losses = [tr.train_step() for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[0] > losses[2]
    assert float(tr.model.block.func.att.K.weight.grad.abs().max()) > 0


@pytest.mark.parametrize("over,err", [
    (dict(attention_norm_idx=1), "column normalisation"),
    (dict(community_window=16), "K5"),
])
def test_unported_eval_routes_raise(monkeypatch, over, err):
    """The two routes this case once held to raising now evaluate: column
    normalisation on CSR through its three-kernel route, the windowed
    strategy through K5's route (``err`` names the route)."""
    from graphax_torch.kernels import attention3, winatt

    calls = []
    mod, name = (attention3, "colnorm_attention_ax_fast") \
        if err == "column normalisation" \
        else (winatt, "windowed_attention_ax_fast")
    real = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: calls.append(1)
                        or real(*a, **k))
    from graphax_torch.functions import transformer

    monkeypatch.setattr(transformer, name, getattr(mod, name))
    tr = _small_trainer(**over)
    assert tr.data.graph.strategy == ("windowed" if err == "K5"
                                      else "sparse")
    assert all(0.0 <= a <= 1.0 for a in tr.evaluate())
    assert len(calls) == tr.last_eval.nfe > 0


@pytest.mark.parametrize("over,err", [
    (dict(community_window=16, attention_norm_idx=1), "Queue 3"),
    (dict(attention_norm_idx=1, beltrami=True, attention_type="exp_kernel",
          feat_hidden_dim=6, pos_enc_hidden_dim=4, pos_enc_dim=3),
     "Beltrami"),
])
def test_still_unported_routes_raise(over, err):
    """The two routes this case once held to raising now run. Beltrami on
    the column route (once ROADMAP Queue 1 item 9's) evaluates on CSR
    through the column route, its split score in attention_gmax's and
    attention_norm's beltrami_exp instances, to graphax's accuracies and
    NFE from the same weights. Column normalisation on the windowed
    strategy (once ROADMAP Queue 3's open entry) takes the column route
    over the windowed graph's CSR and CSC, and trains to graphax's
    step."""
    if err == "Beltrami":
        from graphax.train.loop import Trainer as GxTrainer

        pos = np.random.RandomState(0).randn(60, 3).astype(np.float32)
        kw = dict(SLICE, hidden_dim=8, **over)
        gdata = gx_make_sbm(num_nodes=60, num_classes=3, num_features=8,
                            seed=1)
        gdata = dataclasses.replace(gdata, graph=dataclasses.replace(
            gdata.graph, strategy="sparse")).with_pos_encoding(
                jnp.asarray(pos))
        gtr = GxTrainer(GxConfig(**kw), gdata)
        st = gtr.init_state()
        att = st.params["block"]["func"]["att"]
        rng = np.random.RandomState(5)
        for name in ("Qx", "Kx", "Qp", "Kp"):
            att[name] = {k: jnp.asarray(s * rng.randn(*att[name][k].shape),
                                        jnp.float32)
                         for k, s in (("w", 0.4), ("b", 0.1))}
        tr = _small_trainer(**over)
        tr.data = tr.data.with_pos_encoding(pos)
        assert attention_route(tr.cfg, tr.data.graph,
                               tr.model.state_dim) == "column"
        load_graphax_params(tr.model, *(
            jax.tree_util.tree_map(np.asarray, t)
            for t in (st.params, st.model_state)))
        accs, aux = gtr._eval(st.params, st.model_state, gtr.data)
        assert tr.evaluate() == tuple(float(a) for a in accs)
        assert tr.last_eval.success and tr.last_eval.nfe == int(aux["nfe"])
        return
    from test_torch_grand_nl_train import one_step

    tr = one_step("sparse", "column", batch_norm=True, **over)
    assert tr.data.graph.strategy == "windowed"


@pytest.mark.parametrize("over", [dict(mix_features=True),
                                  dict(multi_modal=True)])
def test_unported_transformer_options_raise(over):
    """Both options once raised here and now train to graphax's step on
    CSR: mix_features with V and Wout's gradients; multi_modal (ROADMAP
    item 10) with no second modality on the per-edge path (its gates keep
    the flash kernels out, as graphax's do), the cross-attention's
    tensors unused."""
    from test_torch_grand_nl_train import one_step

    tr = one_step("sparse", "edge", batch_norm=True, **over)
    att = tr.model.block.func.att
    if over.get("multi_modal"):
        assert attention_route(tr.cfg, tr.data.graph,
                               tr.model.state_dim) == "edge"
        assert all(p.grad is None for p in att.cross.parameters())
        return
    assert float(att.Wout.weight.grad.abs().max()) > 0


def test_transplant_carries_the_transformer_tree():
    gcfg, cfg = _cfgs(hidden_dim=6, attention_type="exp_kernel")
    f = gx_get_function(gcfg, 6)
    params = f.init(jax.random.PRNGKey(2))
    params["att"], _ = random_attention(gcfg, cfg, 6, seed=18)
    tree = jax.tree_util.tree_map(np.asarray, params)
    func = get_function(cfg, 6)
    load_graphax_params(func, tree)
    np.testing.assert_array_equal(func.att.K.weight.detach().numpy(),
                                  tree["att"]["K"]["w"].T)
    assert float(func.att.output_var.detach()) == pytest.approx(1.3)
    assert set(func.state_dict()) == {
        "alpha_train", "beta_train", "att.output_var", "att.lengthscale",
        *(f"att.{m}.{k}" for m in ("Q", "K", "V", "Wout")
          for k in ("weight", "bias"))}
    del tree["att"]["lengthscale"]
    with pytest.raises(KeyError, match="missing"):
        load_graphax_params(func, tree)
    tree["att"]["lengthscale"] = np.ones(())
    tree["att"]["extra"] = np.ones(())
    with pytest.raises(KeyError, match="extra"):
        load_graphax_params(func, tree)
