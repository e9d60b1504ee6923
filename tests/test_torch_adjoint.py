"""The adaptive adjoint's state against graphax's (ROADMAP Queue 3,
"Adaptive adjoint state").

graphax's adjoint integrates one raveled vector: y, a_y and the a_p of every
parameter and per-forward tensor it was handed (`graphax/blocks/common.py
:143-164`, `graphax/ode/solvers.py:566-607`), including leaves whose
gradient it discards (x0, pinned attention) and leaves that stay zero. Its
adaptive controller takes the RMS over all of them, so the port's norm must
run over the same leaves, with the same sizes and values, for the backward
solve to take the same steps.

Here one train step of a small sparse-strategy model (graphax's tiled
strategy on the CPU, i.e. its XLA SpMM), constant and hard-attention blocks,
with an adaptive adjoint: the backward NFE must be equal and the gradients
agree. SGD with lr 1 makes the parameter change the gradient itself.

GRAND-nl (constant block, transformer RHS, random Q/K) takes the same step
under an adaptive and a fixed-grid adjoint: graphax's CPU route is its XLA
fused attention and its autodiff (which its own tests hold to its Pallas
backward, tests/test_pallas_attention.py), the port's the plain versions of
its training kernels. The adaptive case checks the zero-leaf count: the
attention layer's V and Wout and the unread edge weights.
Tolerance: 1e-4 relative / 1e-6 absolute (the f32 adjoint's error
estimates are sums over thousands of terms in another order; the steps are
the same, so the gradients agree to f32 accumulation noise)."""

import dataclasses

import numpy as np
import pytest

import jax

from graphax.data.synthetic import make_sbm_dataset as gx_make_sbm
from graphax.kernels.dispatch import attach_tiles
from graphax.train import Config as GxConfig
from graphax.train.loop import Trainer as GxTrainer

from graphax_torch import Trainer, make_sbm_dataset
from graphax_torch.train import Config
from graphax_torch.utils.transplant import (
    graphax_to_state_dict, load_graphax_params,
)

BASE = dict(dataset="sbm", function="laplacian", hidden_dim=16, heads=2,
            attention_dim=8, attention_type="scaled_dot", att_samp_pct=0.8,
            method="dopri5", tol_scale=1000.0, tol_scale_adjoint=1000.0,
            time=2.0, adjoint=True, batch_norm=False, optimizer="sgd",
            lr=1.0, decay=0.0, input_dropout=0.0, dropout=0.0, max_nfe=2000,
            no_early=True, add_source=True)
SBM = dict(num_nodes=200, num_classes=4, num_features=16, seed=3)


def _one_step(block, adjoint_method, function="laplacian"):
    kw = dict(BASE, block=block, adjoint_method=adjoint_method,
              function=function)
    gdata = gx_make_sbm(**SBM)
    gdata = dataclasses.replace(gdata, graph=dataclasses.replace(
        attach_tiles(gdata.graph), strategy="tiled"))
    gtr = GxTrainer(GxConfig(**kw), gdata)
    state = gtr.init_state()
    params = state.params
    if block == "hard_attention":
        # random Q/K separate the pinned values (tests/test_torch_slice.py)
        rng = np.random.RandomState(7)
        for name in ("Q", "K"):
            w = params["block"]["att_layer"][name]["w"]
            params["block"]["att_layer"][name]["w"] = jax.numpy.asarray(
                0.4 * rng.randn(*w.shape), jax.numpy.float32)
    if function == "transformer":
        # graphax's test scale: the constant 1e-5 init makes A uniform
        rng = np.random.RandomState(8)
        att = params["block"]["func"]["att"]
        for name in ("Q", "K"):
            att[name] = {k: jax.numpy.asarray(
                s * rng.randn(*att[name][k].shape), jax.numpy.float32)
                for k, s in (("w", 0.3), ("b", 0.1))}
    # a nonzero source term and diffusion rate exercise every a_p leaf
    fn = params["block"]["func"]
    fn["alpha_train"] = jax.numpy.asarray(0.3)
    fn["beta_train"] = jax.numpy.asarray(-0.4)
    state = state._replace(params=params)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    before = graphax_to_state_dict(to_np(state.params),
                                   to_np(state.model_state))

    tr = Trainer(Config(**kw), make_sbm_dataset(**SBM, strategy="sparse",
                                                device="cpu"), device="cpu")
    load_graphax_params(tr.model, to_np(state.params),
                        to_np(state.model_state))
    state, gx_loss = gtr.train_step(state)
    pt_loss = tr.train_step()
    after = graphax_to_state_dict(to_np(state.params),
                                  to_np(state.model_state))
    gx_grad = {k: before[k] - after[k] for k in before}
    # the pin is no_grad: the attention layer's parameters get no gradient
    pt_grad = {k: np.zeros(tuple(p.shape), np.float32) if p.grad is None
               else p.grad.numpy() for k, p in tr.model.named_parameters()}
    return (gx_loss, gtr.fm.get_value(), gtr.bm.get_value(), gx_grad,
            pt_loss, tr.fm.get_value(), tr.bm.get_value(), pt_grad)


@pytest.mark.parametrize("adjoint_method", ["adaptive_heun", "dopri5"])
@pytest.mark.parametrize("block", ["constant", "hard_attention"])
def test_adaptive_adjoint_steps_and_gradients_match_graphax(block,
                                                            adjoint_method):
    (gx_loss, gx_nfe, gx_bwd, gx_grad,
     pt_loss, pt_nfe, pt_bwd, pt_grad) = _one_step(block, adjoint_method)
    np.testing.assert_allclose(pt_loss, float(gx_loss), rtol=1e-6)
    assert pt_nfe == gx_nfe
    assert pt_bwd == gx_bwd, (pt_bwd, gx_bwd)
    assert pt_bwd > 12          # an adaptive backward solve with real steps
    assert set(pt_grad) <= set(gx_grad)
    for k, g in pt_grad.items():
        np.testing.assert_allclose(g, gx_grad[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("adjoint_method", ["adaptive_heun", "rk4"])
def test_transformer_adjoint_steps_and_gradients_match_graphax(
        adjoint_method):
    (gx_loss, gx_nfe, gx_bwd, gx_grad,
     pt_loss, pt_nfe, pt_bwd, pt_grad) = _one_step("constant", adjoint_method,
                                                   function="transformer")
    np.testing.assert_allclose(pt_loss, float(gx_loss), rtol=1e-6)
    assert pt_nfe == gx_nfe
    assert pt_bwd == gx_bwd, (pt_bwd, gx_bwd)
    if adjoint_method == "adaptive_heun":
        assert pt_bwd > 12
    assert set(pt_grad) <= set(gx_grad)
    for name in ("Q", "K"):
        assert np.abs(pt_grad[f"block.func.att.{name}.weight"]).max() > 0
    for k, g in pt_grad.items():
        np.testing.assert_allclose(g, gx_grad[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
