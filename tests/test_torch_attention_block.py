"""The attention and mixed blocks and their differentiable pin against
graphax, on the CPU.

- One train step of each of the four presets that use the attention block
  (Cora, Citeseer, Pubmed, CoauthorCS) at toy width (16 hidden, 2 heads of
  4), no dropout, Q and K random, SGD with lr 1 (the parameter change is
  the gradient), on graphax's small SBM (the dense strategy in both): the
  loss within 1e-6 relative, forward and backward NFE equal, every
  gradient, the block's attention layer included, within 1e-4 relative /
  1e-6 absolute (tests/test_torch_adjoint.py's tolerance). Cora and
  Citeseer train by autograd through the accepted steps, Pubmed and
  CoauthorCS through the adaptive adjoint with the ``[N, N]`` operator's
  a_p. Pubmed's adjoint runs the diffusion back over T = 12.9, which
  amplifies rounding: its gradients' atol adds twice graphax's own
  gradient change under a one-ulp change of m1's weights
  (`_one_ulp_spread`).
- The mixed block: its pinned mix at evaluation (the kernel's route) and
  in training (the per-edge route) against graphax's ``mixed_attention``,
  and one train step with ``gamma``'s gradient, as above.
- The attention block on a sparse graph (an adaptive and a fixed-grid
  adjoint: the values' gradient from the plain SDDMM) and on a windowed
  graph (rk4 adjoint: the blocks' gradient from the plain
  ``win_bwd_dense``, the residual's from the plain SDDMM), as above.
- The hard block under column normalisation and squareplus, which the pin
  now serves through the per-edge route: one train step, as above.
- The differentiable pin for every score type, row or column, softmax or
  squareplus: values within 1e-5 / 1e-6 of graphax's
  ``attention_edge_means(differentiable=True)`` and the gradients of a
  random projection of it (Q, K, exp_kernel's two scalars and x) within
  1e-4 / 1e-6 of ``jax.grad``'s.
- An evaluation forward of the block (the pin kernel's plain version,
  and the per-edge route under squareplus): the solve's output within
  1e-4 / 1e-5 and its NFE, and the attention weights."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.blocks import get_block as gx_get_block
from graphax.blocks.common import normalize_graph as gx_normalize_graph
from graphax.data.synthetic import make_sbm_dataset as gx_make_sbm
from graphax.functions.transformer import (
    attention_edge_means as gx_attention_edge_means,
    transformer_attention_init,
)
from graphax.kernels.dispatch import attach_tiles
from graphax.sparse import Graph as GxGraph
from graphax.sparse import build as gx_build
from graphax.train import Config as GxConfig
from graphax.train.loop import Trainer as GxTrainer

from graphax_torch import Trainer, make_sbm_dataset
from graphax_torch.blocks import AttentionBlock, MixedBlock, get_block
from graphax_torch.blocks.common import normalize_graph
from graphax_torch.functions.transformer import (
    TransformerAttention, attention_edge_means,
)
from graphax_torch.sparse.graph import Graph
from graphax_torch.train import Config, best_config
from graphax_torch.utils.transplant import (
    graphax_to_state_dict, load_graphax_params,
)

TOY = dict(hidden_dim=16, heads=2, attention_dim=8, input_dropout=0.0,
           dropout=0.0, optimizer="sgd", lr=1.0, decay=0.0)
SBM = dict(num_nodes=200, num_classes=4, num_features=16, seed=3)
GRAD = dict(rtol=1e-4, atol=1e-6)
ATT_TYPES = ["scaled_dot", "cosine_sim", "pearson", "exp_kernel"]
to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)


def _gx_trainer(cfg, strategy, gamma, sbm, m1_scale=1.0):
    """graphax's Trainer for ``cfg`` and its state from the test's weights:
    random Q and K, alpha 0.3, beta -0.4, ``gamma`` for the mixed block,
    and m1's weights times ``m1_scale``."""
    gdata = gx_make_sbm(**sbm)
    if strategy == "sparse":
        gdata = dataclasses.replace(gdata, graph=dataclasses.replace(
            attach_tiles(gdata.graph), strategy="tiled"))
    gtr = GxTrainer(GxConfig.from_dict(dataclasses.asdict(cfg)), gdata)
    state = gtr.init_state()
    params = state.params
    rng = np.random.RandomState(7)
    for k in ("Q", "K"):
        w = params["block"]["att_layer"][k]["w"]
        params["block"]["att_layer"][k]["w"] = jnp.asarray(
            0.4 * rng.randn(*w.shape), jnp.float32)
    if cfg.attention_type == "exp_kernel":
        params["block"]["att_layer"]["output_var"] = jnp.asarray(1.3)
        params["block"]["att_layer"]["lengthscale"] = jnp.asarray(0.8)
    params["block"]["func"]["alpha_train"] = jnp.asarray(0.3)
    params["block"]["func"]["beta_train"] = jnp.asarray(-0.4)
    if gamma is not None:
        params["block"]["gamma"] = jnp.asarray(gamma)
    params["m1"]["w"] = params["m1"]["w"] * jnp.float32(m1_scale)
    return gtr, state._replace(params=params)


def _gx_change(gtr, state):
    """graphax's train step: (new state, loss, parameter change)."""
    before = graphax_to_state_dict(to_np(state.params),
                                   to_np(state.model_state))
    state, loss = gtr.train_step(state)
    after = graphax_to_state_dict(to_np(state.params),
                                  to_np(state.model_state))
    return state, float(loss), {k: before[k] - after[k] for k in before}


def _step(cfg, strategy="dense", gamma=None, sbm=SBM):
    """One train step of ``cfg`` (a port Config; graphax gets the same
    fields) in both packages from the same weights (`_gx_trainer`).
    ``strategy``: the graph both take ("dense": graphax's auto choice at
    200 nodes; "sparse": graphax's tiled strategy, its XLA SpMM on the
    CPU; "windowed": from ``cfg.community_window`` in both). Returns
    (graphax's loss, NFE, backward NFE, parameter change; the port's loss,
    NFE, backward NFE, gradients)."""
    gtr, state = _gx_trainer(cfg, strategy, gamma, sbm)
    kw = {} if strategy == "dense" else dict(strategy="sparse")
    tr = Trainer(cfg, make_sbm_dataset(**sbm, device="cpu", **kw),
                 device="cpu")
    assert tr.data.graph.strategy == strategy
    assert gtr.data.graph.strategy == ("tiled" if strategy == "sparse"
                                       else strategy)
    load_graphax_params(tr.model, to_np(state.params),
                        to_np(state.model_state))
    _, gx_loss, gx_grad = _gx_change(gtr, state)
    pt_loss = tr.train_step()
    pt_grad = {k: p.grad.float().numpy()
               for k, p in tr.model.named_parameters() if p.grad is not None}
    return (gx_loss, gtr.fm.get_value(), gtr.bm.get_value(),
            {k: gx_grad[k] for k in pt_grad},
            pt_loss, tr.fm.get_value(), tr.bm.get_value(), pt_grad)


def _one_ulp_spread(cfg, strategy="dense", gamma=None, sbm=SBM):
    """How far graphax's own gradients move when m1's weights are scaled by
    ``1 + 2^-23`` (one f32 ulp): per parameter, the largest change. The
    adjoint integrates y back from y(T) (dy/ds = -f): the diffusion run
    backwards, which amplifies the rounding of y(T) over a long horizon,
    so the f32 rounding of either package's products moves the gradients
    by about as much as this."""
    grads = [_gx_change(*_gx_trainer(cfg, strategy, gamma, sbm, scale))[2]
             for scale in (1.0, 1.0 + 2.0 ** -23)]
    return {k: float(np.abs(grads[0][k] - grads[1][k]).max())
            for k in grads[0]}


def _hold(result, extra=(), loss_rtol=1e-6, grad=GRAD, spread=None):
    """The assertions every step test shares: the loss, both NFE, the
    attention layer's Q and K (and ``extra``) given a nonzero gradient,
    and every gradient against graphax's parameter change, within
    ``grad`` plus, where given, twice graphax's ``spread`` of that
    parameter (`_one_ulp_spread`) added to the atol."""
    (gx_loss, gx_nfe, gx_bwd, gx_grad,
     pt_loss, pt_nfe, pt_bwd, pt_grad) = result
    np.testing.assert_allclose(pt_loss, gx_loss, rtol=loss_rtol)
    assert pt_nfe == gx_nfe, (pt_nfe, gx_nfe)
    assert pt_bwd == gx_bwd, (pt_bwd, gx_bwd)
    for k in ("block.att_layer.Q.weight", "block.att_layer.K.weight",
              *extra):
        assert np.abs(pt_grad[k]).max() > 0, k
    for k, g in pt_grad.items():
        atol = grad["atol"] + (2 * spread[k] if spread else 0.0)
        np.testing.assert_allclose(g, gx_grad[k], rtol=grad["rtol"],
                                   atol=atol, err_msg=k)
    return pt_nfe, pt_bwd


@pytest.mark.parametrize("name", ["Cora", "Citeseer", "Pubmed",
                                  "CoauthorCS"])
def test_preset_step_matches_graphax(name):
    cfg = best_config(name, **TOY)
    assert cfg.block == "attention" and cfg.square_plus
    extra = ("block.att_layer.output_var", "block.att_layer.lengthscale") \
        if name == "Citeseer" else ()
    # Pubmed's adjoint runs its diffusion back over T = 12.9: there
    # graphax's own gradients move by up to 1.1e-3 of their largest entry
    # (the attention layer's; 2.2e-4 for m1) under a one-ulp change of m1,
    # and the two packages' f32 products differ by about that much
    spread = _one_ulp_spread(cfg) if name == "Pubmed" else None
    nfe, bwd = _hold(_step(cfg), extra, spread=spread)
    if cfg.adjoint:
        assert bwd > 12       # an adaptive backward solve with real steps
    else:
        assert bwd == nfe     # graphax's meter: the forward's NFE again


def test_mixed_block_pin_and_step_match_graphax():
    cfg = best_config("Pubmed", block="mixed", **TOY)
    gcfg = GxConfig.from_dict(dataclasses.asdict(cfg))
    # the mix itself on the normalised graph: evaluation (the kernel's
    # gate does not cover squareplus: the per-edge route in both) and
    # training, for a row-softmax config (the pin kernel's plain version
    # at evaluation) too
    gdata = gx_make_sbm(**SBM)
    data = make_sbm_dataset(**SBM, device="cpu")
    x = np.random.RandomState(4).randn(SBM["num_nodes"], 16) \
        .astype(np.float32)
    for c, gc in ((cfg, gcfg), (cfg.replace(square_plus=False),
                                gcfg.replace(square_plus=False))):
        gblock = gx_get_block(gc, 16)
        p = gblock.init(jax.random.PRNGKey(0))
        rng = np.random.RandomState(5)
        for k in ("Q", "K"):
            p["att_layer"][k]["w"] = jnp.asarray(
                0.4 * rng.randn(16, 8), jnp.float32)
        p["gamma"] = jnp.asarray(0.7)
        block = get_block(c, 16)
        assert isinstance(block, MixedBlock)
        load_graphax_params(block, to_np(p))
        gg = gx_normalize_graph(gc, gdata.graph)
        g = normalize_graph(c, data.graph)
        for train in (False, True):
            want = gblock.forward.mixed_attention(p, gg, jnp.asarray(x),
                                                  differentiable=train)
            with torch.set_grad_enabled(train):
                got = block.mixed_attention(g, torch.from_numpy(x),
                                            differentiable=train)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), rtol=2e-4,
                                       atol=2e-6)
    # Pubmed's adjoint over T = 12.9: see test_preset_step_matches_graphax
    _hold(_step(cfg, gamma=0.3), extra=("block.gamma",),
          spread=_one_ulp_spread(cfg, gamma=0.3))


@pytest.mark.parametrize("strategy,adjoint_method", [
    ("sparse", "adaptive_heun"), ("sparse", "rk4"), ("windowed", "rk4")])
def test_attention_block_routes_match_graphax(strategy, adjoint_method):
    """The attention block on the CSR and windowed routes (the arxiv
    preset's adjoint and its tolerances, an add_source RHS to exercise
    every a_p): the values' gradient leaves the solve through the SDDMM
    (and the windowed blocks' through win_bwd_dense), their plain versions
    here."""
    window = 64 if strategy == "windowed" else 0
    cfg = Config(dataset="sbm", block="attention", function="laplacian",
                 attention_type="scaled_dot", method="dopri5",
                 tol_scale=1000.0, tol_scale_adjoint=1000.0, time=2.0,
                 adjoint=True, adjoint_method=adjoint_method,
                 max_nfe=2000, no_early=True, add_source=True,
                 community_window=window, **TOY)
    sbm = dict(num_nodes=400, num_classes=4, num_features=16, seed=0) \
        if window else SBM
    nfe, bwd = _hold(_step(cfg, strategy=strategy, sbm=sbm))
    if adjoint_method == "adaptive_heun":
        assert bwd > 12


def test_hard_block_column_squareplus_step_matches_graphax():
    """The hard block on a config its pin kernel does not cover (column
    normalisation, squareplus): the per-edge pin, the quantile and the
    renormalisation over columns, as graphax's; the attention layer gets
    no gradient (the selection is no_grad)."""
    cfg = best_config("Computers", attention_norm_idx=1, square_plus=True,
                      **TOY)
    (gx_loss, gx_nfe, gx_bwd, gx_grad,
     pt_loss, pt_nfe, pt_bwd, pt_grad) = _step(cfg)
    np.testing.assert_allclose(pt_loss, gx_loss, rtol=1e-6)
    assert pt_nfe == gx_nfe and pt_bwd == gx_bwd
    assert "block.att_layer.Q.weight" not in pt_grad
    for k, g in pt_grad.items():
        np.testing.assert_allclose(g, gx_grad[k], err_msg=k, **GRAD)


def _pin_graphs(n=40, e=160, seed=0, pad=6):
    """The same undirected edges with self-loops in both packages, a padded
    buffer, and a node without an edge but its loop."""
    rng = np.random.RandomState(seed)
    row, col = rng.randint(0, n - 1, e), rng.randint(0, n - 1, e)
    keep = row != col
    r, c, w = gx_build.add_self_loops(
        *gx_build.to_undirected(row[keep], col[keep], n), None, 1.0, n)
    gx = GxGraph.from_edges(r, c, n, w, edge_buffer_size=len(r) + pad)
    pt = Graph.from_edges(r, c, n, w, edge_buffer_size=len(r) + pad)
    return gx, pt


@pytest.mark.parametrize("square_plus", [False, True])
@pytest.mark.parametrize("norm_idx", [0, 1])
@pytest.mark.parametrize("att_type", ATT_TYPES)
def test_differentiable_pin_matches_graphax(att_type, norm_idx, square_plus):
    d = 6
    gx, pt = _pin_graphs()
    kw = dict(function="laplacian", heads=2, attention_dim=8, hidden_dim=d,
              attention_type=att_type, attention_norm_idx=norm_idx,
              square_plus=square_plus)
    gcfg, cfg = GxConfig(**kw), Config(**kw)
    p = transformer_attention_init(jax.random.PRNGKey(0), gcfg, d)
    rng = np.random.RandomState(1)
    for name in ("Q", "K"):
        p[name] = {"w": jnp.asarray(rng.randn(d, 8) * 0.5, jnp.float32),
                   "b": jnp.asarray(rng.randn(8) * 0.1, jnp.float32)}
    if att_type == "exp_kernel":
        p["output_var"] = jnp.asarray(1.3)
        p["lengthscale"] = jnp.asarray(0.8)
    att = TransformerAttention(cfg, d)
    load_graphax_params(att, to_np(p))
    x = rng.randn(pt.num_nodes, d).astype(np.float32)
    proj = rng.randn(pt.edge_buffer_size).astype(np.float32)

    def loss(p_, x_):
        m = gx_attention_edge_means(p_, gcfg, gx, x_, differentiable=True)
        return jnp.sum(m * proj), m

    (_, want), (gp, gxx) = jax.value_and_grad(loss, argnums=(0, 1),
                                              has_aux=True)(p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = attention_edge_means(att, cfg, pt, xt, differentiable=True)
    assert got.shape == (pt.edge_buffer_size,) and got.requires_grad
    (got * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    assert np.all(got[pt.num_edges:].detach().numpy() == 0)
    grads = graphax_to_state_dict(to_np(gp))
    named = dict(att.named_parameters())
    for k in ("Q.weight", "Q.bias", "K.weight", "K.bias") + (
            ("output_var", "lengthscale") if att_type == "exp_kernel"
            else ()):
        assert named[k].grad is not None, k
        np.testing.assert_allclose(named[k].grad.numpy(), grads[k],
                                   err_msg=k, **GRAD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gxx), **GRAD)


def test_attention_block_forward_matches_graphax_at_evaluation():
    """An evaluation forward of the block (the pin kernel's plain version
    for a row-softmax config, the per-edge route for the preset's
    squareplus): the solve's output and NFE against graphax's."""
    for over in (dict(), dict(square_plus=False, attention_norm_idx=0)):
        cfg = best_config("CoauthorCS", **TOY, **over)
        gcfg = GxConfig.from_dict(dataclasses.asdict(cfg))
        gblock = gx_get_block(gcfg, 16)
        p = gblock.init(jax.random.PRNGKey(0))
        rng = np.random.RandomState(6)
        for k in ("Q", "K"):
            p["att_layer"][k]["w"] = jnp.asarray(
                0.4 * rng.randn(16, 8), jnp.float32)
        block = get_block(cfg, 16)
        assert isinstance(block, AttentionBlock)
        load_graphax_params(block, to_np(p))
        gdata = gx_make_sbm(**SBM)
        data = make_sbm_dataset(**SBM, device="cpu")
        x = np.random.RandomState(4).randn(SBM["num_nodes"], 16) \
            .astype(np.float32)
        want = gblock.forward(p, gdata.graph, jnp.asarray(x), train=False)
        with torch.no_grad():
            got = block(data.graph, torch.from_numpy(x), train=False)
        assert got.result.nfe == int(want.result.nfe)
        np.testing.assert_allclose(got.z.numpy(), np.asarray(want.z),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(
            block.attention_weights(data.graph,
                                    torch.from_numpy(x)).detach().numpy(),
            np.asarray(gblock.forward.attention_weights(
                p, gdata.graph, jnp.asarray(x))), rtol=1e-4, atol=1e-6)
