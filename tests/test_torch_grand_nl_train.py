"""GRAND-nl (``function="transformer"``) trains on every route graphax
trains it on: one train step of the port against graphax's, on the CPU.

Each case builds the same small SBM graph (60 nodes) in both packages,
draws random Q/K at graphax's test scale (0.3 randn weights, 0.1 randn
biases; the constant 1e-5 init makes the attention uniform), a nonzero
alpha and beta, transplants every weight with `load_graphax_params`, and
compares, with dropout 0:

- the evaluation logits before the step (f32: 1e-4 absolute, NFE equal),
  in the cases without the adjoint (an evaluation does not run it);
- the step's loss (f32: 1e-4 relative), forward and backward NFE (equal);
- every parameter's gradient, Q, K, the encoder and the decoder included
  (f32: 1e-4 absolute plus 1e-3 relative): SGD at lr 1 makes graphax's
  parameter change the gradient itself.

graphax's routes on the CPU are its XLA ones: the materialised dense
attention (its K6 runs on the TPU only), the plain per-edge path on an
untiled sparse graph, and its tiled XLA fused attention on the windowed
graph under column normalisation. The port runs its kernels' plain
versions here. The cases:

- dense, below K6's gate: Cora-like (column softmax under squareplus,
  autograd through the dopri5 steps) and exp_kernel;
- dense with the adaptive dopri5 adjoint, Computers-like: the backward NFE
  is graphax's only if the adjoint's error norm counts graphax's [N, N]
  ``dense_adj`` leaves;
- dense past ``use_dense_attention``'s guard (patched in both packages):
  the sparse routes over the dense graph's CSR and CSC;
- CSR: squareplus, cosine_sim, pearson, exp_kernel and reweight, with
  autograd through the steps and with the rk4 adjoint;
- the windowed graph under column normalisation;
- mix_features on CSR and on a dense graph."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.data.synthetic import make_sbm_dataset as gx_make_sbm
from graphax.kernels import dense_path as gx_dense_path
from graphax.train import Config as GxConfig
from graphax.train.loop import Trainer as GxTrainer

from graphax_torch import Trainer, make_sbm_dataset
from graphax_torch.functions import transformer
from graphax_torch.functions.transformer import attention_route
from graphax_torch.train import Config
from graphax_torch.utils.transplant import (
    graphax_to_state_dict, load_graphax_params,
)

LOSS_RTOL = 1e-4
LOGITS_ATOL = 1e-4
GRAD = dict(rtol=1e-3, atol=1e-4)

BASE = dict(dataset="sbm", block="constant", function="transformer",
            hidden_dim=8, heads=2, attention_dim=8,
            attention_type="scaled_dot", method="dopri5", tol_scale=1000.0,
            tol_scale_adjoint=1000.0, time=2.0, adjoint=False,
            adjoint_method="rk4", adjoint_step_size=0.5, batch_norm=False,
            optimizer="sgd", lr=1.0, decay=0.0, input_dropout=0.0,
            dropout=0.0, max_nfe=2000, no_early=True, add_source=True,
            dtype="float32")
SBM = dict(num_nodes=60, num_classes=3, num_features=8, seed=1, p_in=0.15,
           p_out=0.02)

to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)


def _graphax_trainer(kw, strategy):
    gdata = gx_make_sbm(**SBM)
    if strategy == "sparse":
        # untiled: graphax's RHS takes its plain per-edge path
        gdata = dataclasses.replace(gdata, graph=dataclasses.replace(
            gdata.graph, strategy="sparse"))
    gtr = GxTrainer(GxConfig(**kw), gdata)
    state = gtr.init_state()
    fn = state.params["block"]["func"]
    rng = np.random.RandomState(8)
    att = fn["att"]
    for name in ("Q", "K") + (("V", "Wout") if kw.get("mix_features")
                              else ()):
        att[name] = {k: jnp.asarray(s * rng.randn(*att[name][k].shape),
                                    jnp.float32)
                     for k, s in (("w", 0.3), ("b", 0.1))}
    if kw.get("attention_type") == "exp_kernel":
        att["output_var"] = jnp.asarray(1.3)
        att["lengthscale"] = jnp.asarray(0.8)
    fn["alpha_train"] = jnp.asarray(0.3)
    fn["beta_train"] = jnp.asarray(-0.4)
    return gtr, state


def one_step(strategy, route, **over):
    """graphax's and the port's train step from the same weights; the
    port's route is held to ``route``."""
    kw = dict(BASE, **over)
    gtr, state = _graphax_trainer(kw, strategy)
    tr = Trainer(Config(**kw), make_sbm_dataset(
        **SBM, strategy="sparse" if strategy != "dense" else "auto",
        device="cpu"), device="cpu")
    g = tr.data.graph
    want_strategy = "windowed" if kw.get("community_window") else strategy
    assert g.strategy == gtr.data.graph.strategy.replace("tiled", "sparse") \
        == want_strategy
    assert attention_route(tr.cfg, g, tr.model.state_dim) == route
    load_graphax_params(tr.model, to_np(state.params),
                        to_np(state.model_state))

    if not kw["adjoint"]:
        want, _, aux = jax.jit(lambda pp, ms: gtr.model.apply(
            pp, ms, gtr.data.graph, gtr.data.x, train=False))(
                state.params, state.model_state)
        tr.model.eval()
        with torch.no_grad():
            got, out = tr.model(g, tr.data.x, train=False)
        assert out.result.nfe == int(aux["nfe"])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=LOGITS_ATOL)
        tr.last_eval = out.result           # as Trainer.evaluate keeps it

    before = graphax_to_state_dict(to_np(state.params),
                                   to_np(state.model_state))
    state, gx_loss = gtr.train_step(state)
    loss = tr.train_step()
    after = graphax_to_state_dict(to_np(state.params),
                                  to_np(state.model_state))
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, float(gx_loss), rtol=LOSS_RTOL)
    assert tr.fm.get_value() == gtr.fm.get_value()
    assert tr.bm.get_value() == gtr.bm.get_value()
    grads = {k: np.zeros(tuple(p.shape), np.float32) if p.grad is None
             else p.grad.numpy() for k, p in tr.model.named_parameters()}
    assert set(grads) <= set(before)
    for k, gr in grads.items():
        np.testing.assert_allclose(gr, before[k] - after[k], err_msg=k,
                                   **GRAD)
    for name in ("Q", "K"):
        assert np.abs(grads[f"block.func.att.{name}.weight"]).max() > 0
    return tr


# ----------------------------------------------------------------------
# dense graphs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("over", [
    dict(attention_norm_idx=1, square_plus=True),        # Cora-like
    dict(attention_type="exp_kernel"),
], ids=["cora_like", "exp_kernel"])
def test_dense_below_the_gate(over):
    one_step("dense", "dense", **over)


def test_dense_adaptive_adjoint_counts_graphax_dense_adj():
    """Computers-like: row softmax, the dopri5 adjoint. The backward NFE
    equals graphax's only with graphax's N^2 ``dense_adj`` leaves counted
    in the adjoint's error norm."""
    tr = one_step("dense", "dense", adjoint=True, adjoint_method="dopri5",
                  tol_scale=100.0, tol_scale_adjoint=100.0)
    assert tr.bm.get_value() > 12


@pytest.mark.parametrize("over,route", [
    (dict(attention_norm_idx=1, square_plus=True), "column"),
    (dict(attention_type="cosine_sim", adjoint=True), "flash_replay"),
], ids=["column", "cosine_adjoint"])
def test_dense_past_the_guard(monkeypatch, over, route):
    """``use_dense_attention`` refusing (as at CoauthorCS's 18,333 nodes
    and 4 heads): both packages take their sparse routes over the dense
    graph's edges."""
    monkeypatch.setattr(gx_dense_path, "use_dense_attention",
                        lambda *a, **k: False)
    monkeypatch.setattr(transformer, "use_dense_attention",
                        lambda *a, **k: False)
    from graphax_torch.blocks import common

    monkeypatch.setattr(common, "use_dense_attention", lambda *a, **k: False)
    tr = one_step("dense", route, **over)
    assert tr.data.graph.strategy == "dense"


# ----------------------------------------------------------------------
# CSR
# ----------------------------------------------------------------------

CSR = {"squareplus": dict(square_plus=True),
       "cosine_sim": dict(attention_type="cosine_sim"),
       "pearson": dict(attention_type="pearson"),
       "exp_kernel": dict(attention_type="exp_kernel"),
       "reweight": dict(reweight_attention=True)}


@pytest.mark.parametrize("adjoint", [False, True], ids=["autograd", "rk4"])
@pytest.mark.parametrize("name", list(CSR))
def test_csr_outside_the_hand_written_backward(name, adjoint):
    """The flash forward with the per-edge path's gradient replayed."""
    one_step("sparse", "flash_replay", adjoint=adjoint, **CSR[name])


# ----------------------------------------------------------------------
# the windowed graph under column normalisation, mix_features
# ----------------------------------------------------------------------

@pytest.mark.parametrize("adjoint", [False, True], ids=["autograd", "rk4"])
def test_windowed_column_normalisation(adjoint):
    """The column route over the windowed graph's CSR and CSC; graphax
    leaves the windowed layout for its tiled fused path there."""
    one_step("sparse", "column", community_window=16, attention_norm_idx=1,
             adjoint=adjoint)


@pytest.mark.parametrize("strategy,adjoint", [
    ("sparse", False), ("sparse", True), ("dense", False)])
def test_mix_features(strategy, adjoint):
    """Each head's ``A_h v_h`` through Wout: spmm_multihead on CSR, the
    einsum on a dense graph; V and Wout get their gradients (and are
    adjoint leaves)."""
    tr = one_step(strategy, "edge" if strategy == "sparse" else "dense",
                  mix_features=True, adjoint=adjoint)
    att = tr.model.block.func.att
    for lin in (att.V, att.Wout):
        assert float(lin.weight.grad.abs().max()) > 0
