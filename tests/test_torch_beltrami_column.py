"""Beltrami's split score (``beltrami_exp``) on GRAND-nl's column route
(``attention_norm_idx=1``) against graphax, on the CPU: the route's output
against graphax's three Pallas kernels in interpret mode, its pieces
(attention_gmax, attention_norm's e and den) against graphax's K1 and K2,
its gradient (the replayed per-edge path) against jax.grad of graphax's
XLA route, and one Trainer step on the sparse and the windowed strategy.

Toy widths as graphax's own Beltrami tests build them
(tests/test_pallas_attention.py): features 4, positional 3 and two label
columns in the state (D 9), attention_dim 8, 2 heads, so the K table is
2 x 8 wide and each head's half 4 values. The port runs its kernels'
plain versions here; the card tests hold the kernels to them.

Tolerances:
- The route, e, den and the gradients in f32: rtol 2e-4 / atol 2e-5,
  graphax's own attention tolerance (f32 sums and exps in another order).
- The global max: 1e-6 (the same f32 scores up to their summation order).
- A Trainer step: the loss 1e-4 relative, forward and backward NFE equal,
  every parameter's gradient 1e-3 relative plus 1e-4 absolute (SGD at lr
  1 makes graphax's parameter change its gradient; f32 sums through the
  solve in another order), as tests/test_torch_grand_nl_train.py."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.data.synthetic import make_sbm_dataset as gx_make_sbm
from graphax.functions.transformer import transformer_attention_init
from graphax.kernels.fused_attention import fused_attention_ax
from graphax.kernels.pallas_attention import (
    NEG, _norm_call, _prep_inputs, _scores_call, fused_attention_ax_pallas,
)
from graphax.kernels.pallas_tiled import presence_scale
from graphax.train import Config as GxConfig
from graphax.train.loop import Trainer as GxTrainer

from graphax_torch import Trainer, make_sbm_dataset
from graphax_torch.functions.transformer import (
    TransformerAttention, attention_ax, attention_route,
)
from graphax_torch.kernels import attention3 as a3
from graphax_torch.kernels import fused_attention as fa
from graphax_torch.train import Config
from graphax_torch.utils.transplant import (
    graphax_to_state_dict, load_graphax_params,
)

from test_torch_colnorm import make_graphs

F32 = dict(rtol=2e-4, atol=2e-5)
GMAX = dict(rtol=1e-6, atol=1e-6)
GRAD = dict(rtol=1e-3, atol=1e-4)
LOSS_RTOL = 1e-4
# the state [features 4 | positional 3 | labels 2]
D = 9
BEL = dict(function="transformer", heads=2, attention_dim=8,
           attention_type="exp_kernel", beltrami=True, feat_hidden_dim=4,
           pos_enc_hidden_dim=3, pos_enc_dim=3, attention_norm_idx=1)
SCALARS = {"output_var_x": 1.2, "lengthscale_x": 0.8, "output_var_p": 0.9,
           "lengthscale_p": 1.1}

to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)


def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


def _cfgs(**kw):
    base = dict(BEL, **kw)
    return GxConfig(**base), Config(**base)


def _randomize(p, rng):
    """Random Qx/Kx/Qp/Kp (0.4 randn weights, 0.1 randn biases: squared
    distances of a few units, scores well inside f32) and the kernels'
    scalars away from 1, in graphax's tree ``p``."""
    for name in ("Qx", "Kx", "Qp", "Kp"):
        p[name] = {k: jnp.asarray(rng.randn(*p[name][k].shape) * s,
                                  jnp.float32)
                   for k, s in (("w", 0.4), ("b", 0.1))}
    for name, v in SCALARS.items():
        p[name] = jnp.asarray(v, jnp.float32)


def beltrami_attention(gcfg, cfg, seed):
    """graphax's Beltrami attention tree (random, :func:`_randomize`) and
    the port's layer loaded from it."""
    p = transformer_attention_init(jax.random.PRNGKey(0), gcfg, D)
    _randomize(p, np.random.RandomState(seed))
    att = TransformerAttention(cfg, D)
    load_graphax_params(att, to_np(p))
    return p, att


def _x(pt, seed):
    x = np.random.RandomState(seed).randn(pt.num_nodes, D).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


# ----------------------------------------------------------------------
# the route and its pieces against graphax's interpreted Pallas kernels
# ----------------------------------------------------------------------

@pytest.mark.parametrize("square_plus", [False, True])
@pytest.mark.parametrize("reweight", [False, True])
def test_beltrami_column_route_matches_pallas(square_plus, reweight):
    """The route (K table, global shift, e, column sums, K3 per column)
    against graphax's `fused_attention_ax_pallas` with its transpose
    layout, on a graph with duplicate edges, rows and columns without
    edges and a padded buffer."""
    gx, pt = make_graphs(seed=21)
    gcfg, cfg = _cfgs(square_plus=square_plus, reweight_attention=reweight)
    p, att = beltrami_attention(gcfg, cfg, seed=22)
    xj, xt = _x(pt, 23)
    assert attention_route(cfg, pt, D) == "column"
    want = fused_attention_ax_pallas(gcfg, p, gx.tiles, xj,
                                     edge_weight=gx.edge_weight,
                                     tiles_t=gx.tiles_t)
    with torch.no_grad():
        got = a3.colnorm_attention_ax_fast(cfg, att, pt, xt)
    assert got.dtype == torch.float32 and got.shape == xt.shape
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    assert np.all(got[-4:].numpy() == 0)          # rows with no edge


@pytest.mark.parametrize("square_plus", [False, True])
def test_beltrami_column_pieces_match_graphax_kernels(square_plus):
    """attention_gmax's global max, and attention_norm's e and row sums
    under that one shift, in beltrami_exp against graphax's `_scores_call`
    (K1) and `_norm_call` (K2) with reweight; each head's slot of e at its
    CSR slot."""
    gx, pt = make_graphs(seed=24)
    gcfg, cfg = _cfgs(square_plus=square_plus, reweight_attention=True)
    p, att = beltrami_attention(gcfg, cfg, seed=25)
    xj, xt = _x(pt, 26)
    t = gx.tiles
    q_tiles, xg, wk, bk, wb, scal = _prep_inputs(
        gcfg, p, xj, xj, gx.edge_weight, t.edge_slot, t.slot_mask, t.col,
        t.num_tiles, t.tile)
    scores, rmax = _scores_call("beltrami_exp", True, 2, q_tiles, xg, wk,
                                bk, wb, t.local_row, t.tile_idx, scal,
                                t.num_tiles, t.tile)
    present = presence_scale(t.tile_idx, t.num_tiles) > 0
    gmax = jnp.max(jnp.where(present[:, None, None], rmax, NEG))
    gmax = jnp.where(gmax <= NEG / 2, 0.0, gmax)
    e, den = _norm_call(square_plus, scores, jnp.full_like(rmax, gmax),
                        t.local_row, t.tile_idx, t.num_tiles, t.tile)

    with torch.no_grad():
        ops = fa.prep_inputs(cfg, att, pt, xt)
        scal_p, bel = fa.score_args(ops)
        assert scal_p[0] == "beltrami_exp" and ops["q"].shape == (29, 16)
        kt = fa.attention_kproj(xt, ops["wk"], ops["bk"])
        g = fa.attention_gmax(pt.csr, ops["q"], kt, ops["edge_w"], *scal_p,
                              **bel)
        ep, dp = fa.attention_norm(pt.csr, ops["q"], kt, ops["edge_w"], g,
                                   *scal_p, square_plus=square_plus, **bel)
    np.testing.assert_allclose(float(g), float(gmax), **GMAX)
    h = 2
    keep = np.asarray(t.slot_mask).reshape(-1)
    e_flat = _np(jnp.moveaxis(e, 1, 2).reshape(-1, h))
    want_e = np.zeros((pt.num_edges, h), np.float32)
    want_e[np.asarray(t.edge_slot).reshape(-1)[keep]] = e_flat[keep]
    np.testing.assert_allclose(ep.numpy(), want_e, **F32)
    # graphax's row denominators [tiles, H, tile] by node (0 in a tile
    # without edges)
    den = jnp.where(present[:, None, None], den, 0.0)
    want_den = _np(jnp.moveaxis(den, 1, 2)).reshape(-1, h)[:pt.num_nodes]
    np.testing.assert_allclose(dp.numpy(), want_den, **F32)
    assert not dp[-4:].any()                      # rows with no edge

# ----------------------------------------------------------------------
# the gradient: the replay of the per-edge path against jax.grad
# ----------------------------------------------------------------------

@pytest.mark.parametrize("square_plus,reweight", [(False, False),
                                                  (True, True)])
def test_beltrami_column_gradients_match_graphax(square_plus, reweight):
    """The route under autograd (its kernels forward, the plain per-edge
    path's vjp replayed) against jax.grad of graphax's XLA
    `fused_attention_ax`, the function its custom VJP replays: x, the
    Qx/Kx/Qp/Kp weights and biases and the four scalars."""
    gx, pt = make_graphs(seed=27)
    gcfg, cfg = _cfgs(square_plus=square_plus, reweight_attention=reweight)
    p, att = beltrami_attention(gcfg, cfg, seed=28)
    xj, xt = _x(pt, 29)
    probe = np.random.RandomState(30).randn(pt.num_nodes, D) \
        .astype(np.float32)

    def loss(pp, xx):
        return jnp.sum(fused_attention_ax(gcfg, pp, gx.tiles, xx,
                                          edge_weight=gx.edge_weight,
                                          tiles_t=gx.tiles_t) * probe)

    gp, gxx = jax.grad(loss, argnums=(0, 1))(p, xj)
    xt.requires_grad_(True)
    out = attention_ax(cfg, att, pt, xt)
    (out * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), _np(gxx), **F32)
    for name in ("Qx", "Kx", "Qp", "Kp"):
        lin = getattr(att, name)
        np.testing.assert_allclose(lin.weight.grad.numpy(),
                                   _np(gp[name]["w"]).T, err_msg=name, **F32)
        np.testing.assert_allclose(lin.bias.grad.numpy(), _np(gp[name]["b"]),
                                   err_msg=name, **F32)
    for name in SCALARS:
        np.testing.assert_allclose(float(getattr(att, name).grad),
                                   float(gp[name]), err_msg=name, **F32)


# ----------------------------------------------------------------------
# a Trainer step against graphax's, sparse and windowed
# ----------------------------------------------------------------------

SBM = dict(num_nodes=60, num_classes=3, num_features=8, seed=1, p_in=0.15,
           p_out=0.02)
STEP = dict(BEL, dataset="sbm", block="constant", hidden_dim=8,
            method="dopri5", time=1.5, tol_scale=1000.0, adjoint=True,
            adjoint_method="rk4", adjoint_step_size=0.5, input_dropout=0.0,
            dropout=0.0, batch_norm=False, optimizer="sgd", lr=1.0,
            decay=0.0, add_source=True, no_early=True, max_nfe=2000,
            dtype="float32")


def _pos(n=60, seed=4):
    return np.random.RandomState(seed).randn(n, 3).astype(np.float32)


@pytest.mark.parametrize("window", [0, 16], ids=["sparse", "windowed"])
def test_beltrami_column_train_step_matches_graphax(monkeypatch, window):
    """One GRAND-nl train step with the rk4 adjoint from the same weights,
    on the CSR and on the windowed graph (``community_window`` 16; its CSR
    and CSC carry the column route): the loss, forward and backward NFE,
    and every parameter's gradient; the route's kernels once per forward
    and adjoint NFE."""
    kw = dict(STEP, community_window=window)
    gdata = gx_make_sbm(**SBM)
    gdata = dataclasses.replace(gdata, graph=dataclasses.replace(
        gdata.graph, strategy="sparse")).with_pos_encoding(jnp.asarray(
            _pos()))
    gtr = GxTrainer(GxConfig(**kw), gdata)
    st = gtr.init_state()
    fn = st.params["block"]["func"]
    _randomize(fn["att"], np.random.RandomState(8))
    fn["alpha_train"] = jnp.asarray(0.3)
    fn["beta_train"] = jnp.asarray(-0.4)
    tr = Trainer(Config(**kw), make_sbm_dataset(
        **SBM, strategy="sparse", device="cpu").with_pos_encoding(_pos()),
        device="cpu")
    g = tr.data.graph
    assert g.strategy == ("windowed" if window else "sparse") \
        == gtr.data.graph.strategy.replace("tiled", "sparse")
    assert attention_route(tr.cfg, g, tr.model.state_dim) == "column"
    load_graphax_params(tr.model, to_np(st.params), to_np(st.model_state))
    calls = []
    real = fa.attention_norm
    monkeypatch.setattr(fa, "attention_norm", lambda *a, **k: calls.append(
        a[5]) or real(*a, **k))
    before = graphax_to_state_dict(to_np(st.params), to_np(st.model_state))
    st, gx_loss = gtr.train_step(st)
    loss = tr.train_step()
    after = graphax_to_state_dict(to_np(st.params), to_np(st.model_state))
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, float(gx_loss), rtol=LOSS_RTOL)
    assert tr.fm.get_value() == gtr.fm.get_value()
    assert tr.bm.get_value() == gtr.bm.get_value()
    assert calls == ["beltrami_exp"] * (tr.fm.get_value()
                                        + tr.bm.get_value())
    grads = {k: p.grad.numpy() for k, p in tr.model.named_parameters()
             if p.grad is not None}
    assert {"block.func.att.Qx.weight", "block.func.att.Kp.bias",
            "block.func.att.output_var_p", "mx.weight",
            "mp.weight"} <= set(grads)
    for k, gr in grads.items():
        np.testing.assert_allclose(gr, before[k] - after[k], err_msg=k,
                                   **GRAD)
