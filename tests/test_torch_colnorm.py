"""GRAND-nl with column normalisation (``attention_norm_idx=1``, the Cora,
Citeseer and CoauthorCS tuned configs) on a sparse graph: the port's column
route (K1 + K2 under one global shift, the column denominators, K3 per
edge) and its gradients against graphax, on the CPU.

graphax runs its Pallas three-kernel route (`fused_attention_ax_pallas`
with ``tiles_t``) in interpret mode, as tests/test_pallas_attention.py
does, on row-tiled graphs of tile 8 and 16-slot blocks with duplicate
edges, rows and columns without edges and padded edge buffers; its
gradients are jax.grad of its XLA `fused_attention_ax` (the function its
custom VJP replays). The port runs the plain versions of its kernels.
Inputs come from numpy seeds; weights go through `load_graphax_params`.

Tolerances:
- f32: rtol 2e-4 / atol 2e-5, graphax's own (tests/test_pallas_
  attention.py), values and gradients; Trainer losses 1e-5 relative with
  equal NFE, evaluation logits 1e-4.
- bf16 values: 2e-2 relative / 2e-2 absolute on outputs of size ~1: the
  port's e is f32 as graphax's kernels keep it, its K table f32 where
  graphax's K1 projects each gathered row (the same f32 sums in another
  order), so a rounded weight rnd(mean e / den) can land one bf16 ulp
  apart at the margin and move one term rnd(x w) by one ulp.
- cosine_sim and pearson gradients: graphax's XLA route gives NaN wherever
  a row block has a padded slot (the norm of the zero q row its one-hot
  broadcast gives a padded slot, ROADMAP Queue 3, graphax side); there the
  port is held to jax.grad of graphax's per-edge path, 5e-4 / 5e-5 (the
  tolerance graphax's own tests give that pair)."""

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
from graphax.kernels.dispatch import attach_tiles
from graphax.kernels.fused_attention import fused_attention_ax
from graphax.kernels.pallas_attention import (
    NEG, _attspmm_call, _norm_call, _prep_inputs, _scores_call,
    fused_attention_ax_pallas,
)
from graphax.kernels.pallas_tiled import presence_scale
from graphax.models.gnn import make_gnn
from graphax.sparse import Graph as GxGraph
from graphax.train import Config as GxConfig
from graphax.train.loop import Trainer as GxTrainer

from graphax_torch import Trainer, make_sbm_dataset
from graphax_torch.functions.transformer import (
    TransformerAttention, attention_ax, attention_route,
)
from graphax_torch.kernels import attention3 as a3
from graphax_torch.kernels import fused_attention as fa
from graphax_torch.sparse.graph import Graph
from graphax_torch.train import Config
from graphax_torch.utils.transplant import load_graphax_params

ATT_TYPES = ["scaled_dot", "cosine_sim", "pearson", "exp_kernel"]
F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
EDGE = dict(rtol=5e-4, atol=5e-5)


def make_graphs(n=29, e=120, seed=0, pad=5):
    """The same edges in both packages: the last 4 nodes own no edge (as
    rows and as columns), 12 edges are duplicates, the buffer has ``pad``
    padded slots."""
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
    base = dict(function="transformer", heads=2, attention_dim=8,
                hidden_dim=6, attention_norm_idx=1)
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


def _x(pt, dtype, seed, d=6):
    x = np.random.RandomState(seed).randn(pt.num_nodes, d).astype(np.float32)
    return (jnp.asarray(x).astype(jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


# ----------------------------------------------------------------------
# the route against graphax's interpreted three-kernel route
# ----------------------------------------------------------------------

@pytest.mark.parametrize("att_type", ATT_TYPES)
@pytest.mark.parametrize("square_plus", [False, True])
def test_column_route_matches_pallas(att_type, square_plus):
    gx, pt = make_graphs(seed=1)
    for reweight in (False, True):
        gcfg, cfg = _cfgs(attention_type=att_type, square_plus=square_plus,
                          reweight_attention=reweight)
        p, att = random_attention(gcfg, cfg, 6, seed=2)
        xj, xt = _x(pt, "float32", 3)
        want = fused_attention_ax_pallas(gcfg, p, gx.tiles, xj,
                                         edge_weight=gx.edge_weight,
                                         tiles_t=gx.tiles_t)
        with torch.no_grad():
            got = a3.colnorm_attention_ax_fast(cfg, att, pt, xt)
        assert got.dtype == torch.float32 and got.shape == xt.shape
        np.testing.assert_allclose(got.numpy(), _np(want), err_msg=str(
            reweight), **F32)
        assert np.all(got[-4:].numpy() == 0)          # rows with no edge


@pytest.mark.parametrize("att_type,square_plus", [("scaled_dot", False),
                                                  ("pearson", True)])
def test_column_route_bf16_tracks_pallas(att_type, square_plus):
    gx, pt = make_graphs(seed=4)
    gcfg, cfg = _cfgs(attention_type=att_type, square_plus=square_plus,
                      reweight_attention=True)
    p, att = random_attention(gcfg, cfg, 6, seed=5)
    xj, xt = _x(pt, "bfloat16", 6)
    want = fused_attention_ax_pallas(gcfg, p, gx.tiles, xj,
                                     edge_weight=gx.edge_weight,
                                     tiles_t=gx.tiles_t)
    with torch.no_grad():
        got = a3.colnorm_attention_ax_fast(cfg, att, pt, xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), **BF16)


@pytest.mark.parametrize("square_plus", [False, True])
def test_column_pieces_match_graphax_kernels(square_plus):
    """attention_gmax, attention_norm under that one shift, the column
    denominators and attention_attspmm's per-column form against
    graphax's `_scores_call`, `_norm_call`, its transpose-layout reduce and
    `_attspmm_call(per_edge_denom=True)` (`:1078-1108`)."""
    gx, pt = make_graphs(seed=7)
    gcfg, cfg = _cfgs(square_plus=square_plus, attention_type="exp_kernel",
                      reweight_attention=True)
    p, att = random_attention(gcfg, cfg, 6, seed=8)
    xj, xt = _x(pt, "float32", 9)
    t, tt = gx.tiles, gx.tiles_t
    q_tiles, xg, wk, bk, wb, scal = _prep_inputs(
        gcfg, p, xj, xj, gx.edge_weight, t.edge_slot, t.slot_mask, t.col,
        t.num_tiles, t.tile)
    scores, rmax = _scores_call("exp_kernel", True, 2, q_tiles, xg, wk, bk,
                                wb, t.local_row, t.tile_idx, scal,
                                t.num_tiles, t.tile)
    present = presence_scale(t.tile_idx, t.num_tiles) > 0
    gmax = jnp.max(jnp.where(present[:, None, None], rmax, NEG))
    gmax = jnp.where(gmax <= NEG / 2, 0.0, gmax)
    e, _ = _norm_call(square_plus, scores, jnp.full_like(rmax, gmax),
                      t.local_row, t.tile_idx, t.num_tiles, t.tile)
    h = 2
    e_flat = jnp.moveaxis(e, 1, 2).reshape(-1, h)
    e_t = jnp.where(tt.slot_mask[..., None],
                    e_flat[tt.perm_from_row].reshape(tt.col.shape + (h,)),
                    0.0)
    oh_t = jax.nn.one_hot(tt.local_row, tt.tile, dtype=jnp.float32)
    dn = jax.ops.segment_sum(jnp.einsum("ber,beh->brh", oh_t, e_t),
                             tt.tile_idx, num_segments=tt.num_tiles)
    den_n = dn.reshape(-1, h)[:gx.num_nodes]
    out = _attspmm_call(e, jnp.moveaxis(den_n[t.col], 2, 1), xg,
                        t.local_row, t.tile_idx, t.num_tiles, t.tile,
                        per_edge_denom=True)
    out = jnp.where(present[:, None, None], out, 0.0) \
        .reshape(-1, 6)[:gx.num_nodes]

    with torch.no_grad():
        ops = fa.prep_inputs(cfg, att, pt, xt)
        scal_p = (cfg.attention_type, 2, ops["ov2"], ops["inv2l2"])
        kt = fa.attention_kproj(xt, ops["wk"], ops["bk"])
        g = fa.attention_gmax(pt.csr, ops["q"], kt, ops["edge_w"], *scal_p)
        ep, _ = fa.attention_norm(pt.csr, ops["q"], kt, ops["edge_w"], g,
                                  *scal_p, square_plus=square_plus)
        den = a3.column_denominators(pt.csc, ep)
        got = fa.attention_attspmm(pt.csr, ep, den, xt, per_column=True)
    np.testing.assert_allclose(float(g), float(gmax), **F32)
    keep = np.asarray(t.slot_mask).reshape(-1)
    want_e = np.zeros((pt.num_edges, h), np.float32)
    want_e[np.asarray(t.edge_slot).reshape(-1)[keep]] = _np(e_flat)[keep]
    np.testing.assert_allclose(ep.numpy(), want_e, **F32)
    np.testing.assert_allclose(den.numpy(), _np(den_n), **F32)
    assert np.all(den[-4:].numpy() == 0)             # columns with no edge
    np.testing.assert_allclose(got.numpy(), _np(out), **F32)


def test_column_denominators_sum_each_column_subnormals_kept():
    """The column sums of e over the CSC layout against a float64 sum per
    column, two heads: columns with no edge hold 0, and a column whose
    weights are all f32 subnormals (its scores ~95 or more below the one
    global shift) keeps its subnormal sum, which K3's zero-select would
    otherwise take for an empty column."""
    _, pt = make_graphs(seed=3)
    e = np.random.RandomState(4).rand(pt.num_edges, 2).astype(np.float32)
    col = pt.col[:pt.num_edges].numpy()
    sub = col == col[0]
    e[sub] = np.exp(-95.0 - np.arange(2 * sub.sum()).reshape(-1, 2)
                    ).astype(np.float32)
    assert 0 < e[sub].max() < np.finfo(np.float32).tiny
    got = a3.column_denominators(pt.csc, torch.from_numpy(e)).numpy()
    want = np.zeros((pt.num_nodes, 2))
    np.add.at(want, col, e.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got[col[0]] > 0).all() and not got[-4:].any()


# ----------------------------------------------------------------------
# gradients: the route's replay against jax.grad of graphax's XLA route
# ----------------------------------------------------------------------

def _edge_ax(gcfg, p, gx, x):
    g = dataclasses.replace(gx, tiles=None, tiles_t=None, strategy="edge")
    att, (v, _) = gx_attention_apply(p, gcfg, g, x)
    return gx_multiply_attention(p, gcfg, g, x, att, v)


@pytest.mark.parametrize("att_type,square_plus,reweight", [
    ("scaled_dot", False, False), ("scaled_dot", True, True),
    ("exp_kernel", False, False), ("cosine_sim", True, False)])
def test_column_route_gradients_match_graphax(att_type, square_plus,
                                              reweight):
    gx, pt = make_graphs(seed=10)
    gcfg, cfg = _cfgs(attention_type=att_type, square_plus=square_plus,
                      reweight_attention=reweight)
    p, att = random_attention(gcfg, cfg, 6, seed=11)
    xj, xt = _x(pt, "float32", 12)
    probe = np.random.RandomState(13).randn(pt.num_nodes, 6) \
        .astype(np.float32)

    def loss(pp, xx):
        return jnp.sum(fused_attention_ax(gcfg, pp, gx.tiles, xx,
                                          edge_weight=gx.edge_weight,
                                          tiles_t=gx.tiles_t) * probe)

    gp, gxx = jax.grad(loss, argnums=(0, 1))(p, xj)
    tol = F32
    if att_type == "cosine_sim":
        assert not np.isfinite(_np(gxx)).all()          # graphax's NaN
        gp, gxx = jax.grad(lambda pp, xx: jnp.sum(
            _edge_ax(gcfg, pp, gx, xx) * probe), argnums=(0, 1))(p, xj)
        tol = EDGE
    xt.requires_grad_(True)
    out = attention_ax(cfg, att, pt, xt)
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
                                       float(gp[name]), err_msg=name, **tol)
    assert att.V.weight.grad is None and att.Wout.weight.grad is None


def test_column_route_is_fast_in_training_too(monkeypatch):
    """The column route (its kernels forward, the replay backward) serves
    evaluation and training alike: one RHS with and without a gradient
    runs attention_attspmm once."""
    _, pt = make_graphs()
    gcfg, cfg = _cfgs()
    assert attention_route(cfg, pt, 6) == "column"
    _, att = random_attention(gcfg, cfg, 6)
    calls = []
    real = fa.attention_attspmm
    monkeypatch.setattr(fa, "attention_attspmm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for grad in (False, True):
        x = torch.randn(pt.num_nodes, 6, requires_grad=grad)
        calls.clear()
        with torch.set_grad_enabled(grad):
            out = attention_ax(cfg, att, pt, x)
        assert len(calls) == 1 and out.requires_grad == grad


# ----------------------------------------------------------------------
# Trainer steps against graphax's
# ----------------------------------------------------------------------

SLICE = dict(dataset="sbm", block="constant", function="transformer",
             hidden_dim=16, heads=2, attention_dim=8,
             attention_type="scaled_dot", attention_norm_idx=1,
             method="dopri5", tol_scale=11353.558848254957, time=3.0,
             adjoint_method="rk4", adjoint_step_size=1.0, batch_norm=True,
             optimizer="rmsprop", lr=0.002, decay=0.0, input_dropout=0.0,
             dropout=0.0, max_nfe=500, no_early=True, dtype="float32")
# (at the arxiv preset's lr, 0.0055, graphax's own third adjoint step on
# this graph runs its forward solve into max_nfe and returns a NaN loss)
SBM = dict(num_nodes=300, num_classes=4, num_features=16, seed=0)


@pytest.mark.parametrize("over", [dict(adjoint=True),
                                  dict(adjoint=False, square_plus=True)])
def test_column_trainer_matches_graphax(monkeypatch, over):
    """Three train steps and an evaluation: f32 losses 1e-5 relative, NFE
    equal, logits 1e-4; the column route once per forward and adjoint
    NFE."""
    calls = []
    real = fa.attention_attspmm

    def counting(*a, **k):
        calls.append(k.get("per_column"))
        return real(*a, **k)

    monkeypatch.setattr(fa, "attention_attspmm", counting)
    kw = dict(SLICE, **over)
    gdata = gx_make_sbm(**SBM)
    gdata = dataclasses.replace(gdata, graph=dataclasses.replace(
        attach_tiles(gdata.graph), strategy="tiled"))
    gtr = GxTrainer(GxConfig(**kw), gdata)
    state = gtr.init_state()
    att = state.params["block"]["func"]["att"]
    rng = np.random.RandomState(7)
    for name in ("Q", "K"):
        att[name]["w"] = jnp.asarray(0.4 * rng.randn(*att[name]["w"].shape),
                                     jnp.float32)
    tr = Trainer(Config(**kw), make_sbm_dataset(**SBM, strategy="sparse",
                                                device="cpu"), device="cpu")
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    load_graphax_params(tr.model, to_np(state.params),
                        to_np(state.model_state))
    for _ in range(3):
        state, gloss = gtr.train_step(state)
        calls.clear()
        loss = tr.train_step()
        assert np.isfinite(loss)
        np.testing.assert_allclose(loss, float(gloss), rtol=1e-5)
        assert tr.fm.get_value() == gtr.fm.get_value()
        if over["adjoint"]:
            assert tr.bm.get_value() == gtr.bm.get_value()
        want = tr.fm.get_value() + (tr.bm.get_value() if over["adjoint"]
                                    else 0)
        assert calls == [True] * want
    model = make_gnn(GxConfig(**kw), gtr.data.num_features,
                     gtr.data.num_classes)
    want, _, aux = jax.jit(lambda pp, ms: model.apply(
        pp, ms, gtr.data.graph, gtr.data.x, train=False))(state.params,
                                                          state.model_state)
    tr.model.eval()
    with torch.no_grad():
        got, out = tr.model(tr.data.graph, tr.data.x, train=False)
    assert out.result.nfe == int(aux["nfe"])
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)
