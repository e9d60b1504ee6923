"""The higher-order, rewire-attention and hard-attention blocks and the CGNN
baseline of graphax_torch against graphax.

graphax's oracles (tests/test_blocks_models.py: test_higher_order_block,
test_cgnn_forward) run on the port. Each block's solve equals graphax's
from transplanted weights on the same graph and state: z to 1e-5 (f32 sums
in another order), NFE equal; gradients rtol 1e-4 / atol 1e-6 (train
steps through `torch_surface_helpers.step_both`, loss 1e-6). The rewire
block's top entries follow ``jax.lax.top_k``'s order on a matrix with ties;
its random edges are graphax's draw (``PRNGKey(0)``), handed to the port's
block. The hard block over a transformer or GAT RHS takes the function's
attention; the transformer RHS recomputes attention from the graph, so the
pinned values reach the solve only through the windowed reweight's blocks,
in graphax as in the port."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.blocks import get_block as gx_get_block
from graphax.blocks import make_higher_order_block as gx_higher_order
from graphax.blocks.rewire_attention import _top_edges as gx_top_edges
from graphax.data.synthetic import make_sbm_dataset as gx_make_sbm
from graphax.models import make_cgnn as gx_make_cgnn
from graphax.models.cgnn import normalize_for_cgnn as gx_normalize_for_cgnn
from graphax.train import Config as GxConfig

from graphax_torch import Trainer, make_sbm_dataset
from graphax_torch.blocks import get_block, make_higher_order_block
from graphax_torch.blocks.rewire_attention import top_edges
from graphax_torch.drivers.run_cgnn import train_cgnn
from graphax_torch.models import make_cgnn, normalize_for_cgnn
from graphax_torch.train import Config
from graphax_torch.utils.transplant import load_graphax_params

from torch_surface_helpers import (  # noqa: F401 (one_torch_thread)
    BASE, force, one_torch_thread, step_both, to_np,
)

SBM = dict(num_nodes=60, num_classes=3, num_features=8, seed=1)


def _state(n, d, seed=0):
    x = np.random.RandomState(seed).randn(n, d).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _graphs(strategy="dense", sbm=SBM):
    gx = gx_make_sbm(**sbm).graph
    pt = make_sbm_dataset(**sbm, strategy=strategy, device="cpu").graph
    return gx, pt


def _port_block(block, params):
    load_graphax_params(block, to_np(params))
    return block


# ----------------------------------------------------------------------
# higher-order block
# ----------------------------------------------------------------------

HO = dict(hidden_dim=6, function="laplacian", method="rk4", step_size=0.25,
          time=2.0, self_loop_weight=1.0)


def test_higher_order_block_oracle():
    """graphax's oracle: order 2 integrates, differs from order 1 (the
    constant block), and gradients flow through the augmented solve."""
    _, g = _graphs("sparse")
    _, x = _state(60, 6)
    cfg = Config(**HO)
    b2 = make_higher_order_block(cfg, 6, order=2)
    b1 = make_higher_order_block(cfg, 6, order=1)
    b2.reset_parameters(torch.Generator().manual_seed(0))
    b1.load_state_dict(b2.state_dict())
    z2 = b2(g, x, train=False).z
    z1 = b1(g, x, train=False).z
    assert z2.shape == x.shape and torch.isfinite(z2).all()
    assert float((z2 - z1).abs().max()) > 1e-3
    loss = torch.sum(b2(g, x, train=True).z ** 2)
    loss.backward()
    grads = [p.grad for p in b2.parameters() if p.grad is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("adjoint", [False, True])
def test_higher_order_block_equals_graphax(order, adjoint):
    gcfg = GxConfig(**HO, adjoint=adjoint, adjoint_method="rk4")
    cfg = Config(**HO, adjoint=adjoint, adjoint_method="rk4")
    gg, g = _graphs("sparse")
    xj, xt = _state(60, 6)
    gblk = gx_higher_order(gcfg, 6, order=order)
    params = gblk.init(jax.random.PRNGKey(0))
    params["func"]["alpha_train"] = jnp.float32(0.3)
    params["func"]["beta_train"] = jnp.float32(-0.4)
    blk = _port_block(make_higher_order_block(cfg, 6, order=order), params)

    def gx_loss(p, x):
        out = gblk.forward(p, gg, x, train=True)
        return jnp.sum(jnp.tanh(out.z)), out.result.nfe

    (want, nfe), (gp, gxg) = jax.value_and_grad(gx_loss, argnums=(0, 1),
                                                has_aux=True)(params, xj)
    xt = xt.clone().requires_grad_(True)
    out = blk(g, xt, train=True)
    loss = torch.sum(torch.tanh(out.z))
    loss.backward()
    assert out.result.nfe == int(nfe)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    # the state's gradient (entries up to 2, f32 sums through 8 RK4 steps
    # of every order's chain): 1e-4 relative, 2e-6 absolute
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gxg), rtol=1e-4,
                               atol=2e-6)
    np.testing.assert_allclose(float(blk.func.alpha_train.grad),
                               float(gp["func"]["alpha_train"]), rtol=1e-4)
    with torch.no_grad():
        z = blk(g, xt, train=False).z
    np.testing.assert_allclose(
        z.numpy(), np.asarray(gblk.forward(params, gg, xj, train=False).z),
        rtol=1e-5, atol=1e-5)


def test_higher_order_block_takes_no_regulariser():
    """graphax's regularised RHS takes a one-tensor state; its higher-order
    block fails there too (a tuple has no ``*``)."""
    cfg = Config(**HO, kinetic_energy=1.0)
    _, g = _graphs("sparse")
    _, x = _state(60, 6)
    blk = make_higher_order_block(cfg, 6, order=2)
    with pytest.raises(TypeError):
        blk(g, x, train=True)


# ----------------------------------------------------------------------
# rewire-attention block
# ----------------------------------------------------------------------

def test_top_edges_tie_order_equals_lax_top_k():
    rng = np.random.RandomState(0)
    dense = rng.choice([0.0, 0.25, 0.5, 0.5, 1.0], size=(9, 9)) \
        .astype(np.float32)
    dense[3] = 0.5                      # a row of ties
    for cap in (5, 17, 40, 81):
        want = gx_top_edges(jnp.asarray(dense), cap)
        got = top_edges(torch.from_numpy(dense), cap)
        for w, g in zip(want[:3], got[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[3] == int(want[3])


RW = dict(hidden_dim=8, heads=2, attention_dim=8, block="rewire_attention",
          method="rk4", step_size=0.5, time=1.0, att_samp_pct=0.6,
          self_loop_weight=1.0)


def _rewire_both(function, new_edges):
    kw = dict(RW, function=function, new_edges=new_edges)
    gcfg, cfg = GxConfig(**kw), Config(**kw)
    gg, g = _graphs("dense")
    xj, xt = _state(60, 8)
    gblk = gx_get_block(gcfg, 8)
    params = gblk.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(4)
    layer = params.get("att_layer", params["func"].get("att"))
    if function == "GAT":
        layer = params["func"]["att"]
        layer["a"] = jnp.asarray(rng.randn(*layer["a"].shape), jnp.float32)
    else:
        for k in ("Q", "K"):
            layer[k]["w"] = jnp.asarray(0.5 * rng.randn(*layer[k]["w"].shape),
                                        jnp.float32)
    params["func"]["alpha_train"] = jnp.float32(0.3)
    blk = _port_block(get_block(cfg, 8), params)
    m = max(int(60 * (1.0 / (1.0 - cfg.rw_addD) - 1.0)), 1)
    blk.random_edges = torch.from_numpy(np.asarray(jax.random.randint(
        jax.random.PRNGKey(0), (2, m), 0, 60)))
    return gblk, params, gg, xj, blk, g, xt


@pytest.mark.parametrize("function", ["laplacian", "transformer", "GAT"])
@pytest.mark.parametrize("new_edges", ["k_hop_att", "random"])
def test_rewire_block_equals_graphax(function, new_edges):
    gblk, params, gg, xj, blk, g, xt = _rewire_both(function, new_edges)
    for train in (True, False):
        want = gblk.forward(params, gg, xj, train=train)
        with torch.no_grad():
            got = blk(g, xt, train=train)
        assert got.result.nfe == int(want.result.nfe)
        np.testing.assert_allclose(got.z.numpy(), np.asarray(want.z),
                                   rtol=1e-5, atol=1e-5)
    g2, vals = blk.rewire(g, blk.mean_attention(g, xt, pin=False).detach())
    assert g2.strategy == "dense" and g2.num_edges > 0
    assert g2.edge_buffer_size == g.edge_buffer_size
    key = g2.row[:g2.num_edges] * 60 + g2.col[:g2.num_edges]
    assert bool((key[1:] > key[:-1]).all())         # the CSR order
    assert float(vals[g2.num_edges:].abs().max()) == 0.0


def test_rewire_block_train_step_equals_graphax():
    """A Trainer step of the rewire block (dense graph, k-hop edges) from
    graphax's weights."""
    step_both(dict(BASE, block="rewire_attention", new_edges="k_hop_att",
                   att_samp_pct=0.6), "dense", qk_scale=0.4)


# ----------------------------------------------------------------------
# hard-attention block
# ----------------------------------------------------------------------

@pytest.mark.parametrize("function", ["laplacian", "transformer", "GAT"])
def test_hard_block_step_equals_graphax(function):
    kw = dict(BASE, block="hard_attention", function=function,
              att_samp_pct=0.7, adjoint=True, adjoint_method="rk4")
    tr = step_both(kw, "sparse", qk_scale=0.4)
    assert hasattr(tr.model.block, "att_layer") == (function == "laplacian")


@pytest.mark.parametrize("strategy", ["sparse", "windowed"])
def test_use_flux_step_equals_graphax(strategy):
    kw = dict(BASE, block="hard_attention", use_flux=True, att_samp_pct=0.7)
    with force(strategy == "windowed"):
        step_both(kw, strategy, qk_scale=0.4)


@pytest.mark.parametrize("strategy,reads", [("sparse", False),
                                            ("windowed", True)])
def test_transformer_reads_the_pin_only_through_the_reweight(strategy,
                                                             reads):
    """The hard block pins the transformer's attention, but its RHS
    recomputes attention from the graph: a different kept set changes the
    solve only where the windowed route reweights with the blocks built
    from the pinned values (graphax's ``fstate.wb[0]``), in both
    packages."""
    kw = dict(BASE, block="hard_attention", function="transformer",
              reweight_attention=True, time=1.0)
    zs = {}
    with force(strategy == "windowed"):
        for pct in (0.5, 1.0):
            tr = step_both(dict(kw, att_samp_pct=pct), strategy,
                           qk_scale=0.4)
            fstate_in = tr.model.encode(tr.data.x, train=False)
            with torch.no_grad():
                zs[pct] = tr.model.block(tr.data.graph, fstate_in,
                                         train=True).z
    differs = float((zs[0.5] - zs[1.0]).abs().max()) > 1e-6
    assert differs == reads


# ----------------------------------------------------------------------
# CGNN
# ----------------------------------------------------------------------

CG = dict(hidden_dim=8, time=1.0, method="dopri5", tol_scale=100.0,
          alpha=1.0, input_dropout=0.0, dropout=0.0)


def test_cgnn_forward_oracle():
    _, g = _graphs("sparse")
    _, x = _state(60, 8)
    model = make_cgnn(Config(**CG), num_features=8, num_classes=3)
    model.init_for_graph(g, torch.Generator().manual_seed(0))
    logits, aux = model(normalize_for_cgnn(g), x, train=False)
    assert logits.shape == (60, 3) and torch.isfinite(logits).all()
    assert model.alpha_train.shape == (60,) and aux["success"]


@pytest.mark.parametrize("strategy", ["dense", "sparse"])
def test_cgnn_equals_graphax(strategy):
    gg, g = _graphs(strategy)
    xj, xt = _state(60, 8, seed=3)
    gm = gx_make_cgnn(GxConfig(**CG), 8, 3)
    params = gm.init_for_graph(jax.random.PRNGKey(0), gg)
    params["alpha_train"] = jnp.asarray(
        np.random.RandomState(0).randn(60), jnp.float32)
    model = make_cgnn(Config(**CG), 8, 3)
    model.init_for_graph(g, torch.Generator().manual_seed(0))
    load_graphax_params(model, to_np(params))
    gng = gx_normalize_for_cgnn(gg)

    def gx_loss(p):
        logits, aux = gm.apply(p, gng, xj, train=True,
                               rng=jax.random.PRNGKey(1))
        return jnp.sum(logits ** 2), aux["nfe"]

    (want, nfe), grads = jax.value_and_grad(gx_loss, has_aux=True)(params)
    logits, aux = model(normalize_for_cgnn(g), xt, train=True)
    loss = torch.sum(logits ** 2)
    loss.backward()
    assert aux["nfe"] == int(nfe)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(model.alpha_train.grad.numpy(),
                               np.asarray(grads["alpha_train"]), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(model.m1.weight.grad.numpy(),
                               np.asarray(grads["m1"]["w"]).T, rtol=1e-4,
                               atol=1e-6)


def test_train_cgnn_driver():
    data = make_sbm_dataset(**SBM, device="cpu")
    out = train_cgnn("sbm", epochs=2, hidden_dim=8, log_every=0,
                     device="cpu", data=data)
    assert {"val_acc", "test_acc", "history"} <= set(out)
    assert len(out["history"]) == 2
    for h in out["history"]:
        assert np.isfinite(h["loss"]) and h["success"] and h["nfe"] > 0


def test_trainer_does_not_read_cgnn():
    """graphax's Trainer leaves ``cfg.cgnn`` to the driver; so does the
    port's."""
    data = make_sbm_dataset(**SBM, device="cpu")
    tr = Trainer(Config(block="constant", hidden_dim=8, cgnn=True,
                        no_early=True), data, device="cpu")
    assert np.isfinite(tr.train_step())
