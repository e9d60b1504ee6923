"""Shared by the tests of the port's single-graph model surface: one train
step of graphax's Trainer and of the port's from the same weights, held to
each other."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphax.data.synthetic import make_sbm_dataset as gx_make_sbm
from graphax.kernels import pallas_tiled, pallas_windows
from graphax.kernels.dispatch import attach_tiles
from graphax.train import Config as GxConfig
from graphax.train.loop import Trainer as GxTrainer

from graphax_torch import Trainer, make_sbm_dataset
from graphax_torch.train import Config
from graphax_torch.utils.transplant import (
    graphax_to_state_dict, load_graphax_params,
)

to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tests' tensors are small: one intra-op thread each. Under the
    suite's parallel workers, torch's default of a thread per core made
    their many small ops spin against each other (a step took minutes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def force(on: bool):
    """graphax's windowed and tiled Pallas kernels on the CPU (interpret
    mode), as its own tests run them, or not."""
    old = pallas_windows.FORCE, pallas_tiled.FORCE
    pallas_windows.FORCE = pallas_tiled.FORCE = on
    try:
        yield
    finally:
        pallas_windows.FORCE, pallas_tiled.FORCE = old


BASE = dict(dataset="sbm", function="laplacian", block="constant",
            hidden_dim=16, method="rk4", step_size=0.5, time=1.0,
            batch_norm=False, optimizer="sgd", lr=1.0, decay=0.0,
            input_dropout=0.0, dropout=0.0, max_nfe=2000, no_early=True,
            add_source=True, tol_scale=1000.0, tol_scale_adjoint=1000.0,
            heads=2, attention_dim=8)
SBM = dict(num_nodes=120, num_classes=3, num_features=12, seed=3)
WIN_SBM = dict(num_nodes=400, num_classes=4, num_features=32, seed=0)
ADJ = {"plain": dict(adjoint=False),
       "rk4": dict(adjoint=True, adjoint_method="rk4"),
       "adaptive": dict(adjoint=True, adjoint_method="adaptive_heun",
                        method="dopri5")}


def step_both(kw, strategy, qk_scale=0.0, sbm=None):
    """One SGD step (lr 1: the parameter change is the gradient) of
    graphax's Trainer and the port's from the same weights; asserts
    loss, NFE and gradients. ``qk_scale``: random Q/K weights of that
    scale in the attention layers (the constant 1e-5 init makes attention
    uniform), random scores for GAT."""
    if strategy == "windowed":
        kw = dict(kw, community_window=64)
        sbm = sbm or WIN_SBM
        gdata = gx_make_sbm(**sbm)
        pdata = make_sbm_dataset(**sbm, strategy="sparse", device="cpu")
    elif strategy == "sparse":
        sbm = sbm or SBM
        gdata = gx_make_sbm(**sbm)
        gdata = dataclasses.replace(gdata, graph=dataclasses.replace(
            attach_tiles(gdata.graph), strategy="tiled"))
        pdata = make_sbm_dataset(**sbm, strategy="sparse", device="cpu")
    else:
        sbm = sbm or SBM
        gdata = gx_make_sbm(**sbm)
        pdata = make_sbm_dataset(**sbm, device="cpu")
    gtr = GxTrainer(GxConfig(**kw), gdata)
    if strategy == "windowed":
        assert gtr.data.graph.windows.hub is None
    state = gtr.init_state()
    params = state.params
    fn = params["block"]["func"]
    fn["alpha_train"], fn["beta_train"] = jnp.float32(0.3), jnp.float32(-.4)
    rng = np.random.RandomState(7)
    for layer in (params["block"].get("att_layer"), fn.get("att")):
        if layer is None or not qk_scale:
            continue
        if "a" in layer:                     # GAT: its score vector
            layer["a"] = jnp.asarray(rng.randn(*layer["a"].shape),
                                     jnp.float32)
            continue
        for k in ("Q", "K"):
            layer[k]["w"] = jnp.asarray(
                qk_scale * rng.randn(*layer[k]["w"].shape), jnp.float32)
    state = state._replace(params=params)
    before = graphax_to_state_dict(to_np(state.params),
                                   to_np(state.model_state))
    tr = Trainer(Config(**kw), pdata, device="cpu")
    assert tr.data.graph.strategy == strategy
    load_graphax_params(tr.model, to_np(state.params),
                        to_np(state.model_state))
    state, gx_loss = gtr.train_step(state)
    pt_loss = tr.train_step()
    after = graphax_to_state_dict(to_np(state.params),
                                  to_np(state.model_state))
    np.testing.assert_allclose(pt_loss, float(gx_loss), rtol=1e-6)
    assert tr.fm.get_value() == gtr.fm.get_value()
    assert tr.bm.get_value() == gtr.bm.get_value(), (tr.bm.get_value(), gtr.bm.get_value())
    for k, p in tr.model.named_parameters():
        g = np.zeros(tuple(p.shape), np.float32) if p.grad is None \
            else p.grad.numpy()
        np.testing.assert_allclose(g, before[k] - after[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    return tr


# the windowed adaptive adjoint's cases (tests/test_torch_surface_windowed_*)
WINDOWED_CASES = {
    "constant": dict(),
    "hard_attention": dict(block="hard_attention", att_samp_pct=0.8),
    "attention": dict(block="attention"),
    "transformer": dict(function="transformer"),
    "transformer_reweight": dict(function="transformer",
                                 reweight_attention=True),
}


def windowed_adaptive_step(case, adjoint_method):
    """One step of ``case`` under ``adjoint_method`` on the windowed graph,
    graphax FORCE'd, held by `step_both`."""
    kw = dict(BASE, **WINDOWED_CASES[case], method="dopri5", time=1.5,
              adjoint=True, adjoint_method=adjoint_method)
    qk = 0.3 if case.startswith("transformer") else 0.4
    with force(True):
        tr = step_both(kw, "windowed", qk_scale=qk)
    assert tr.bm.get_value() > 8     # an adaptive backward with real steps
