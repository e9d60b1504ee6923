"""Regularised Trainer steps of graphax_torch against graphax's, beyond
one rate at a time (tests/test_torch_surface_reg.py): all four rates on
the dense, sparse and windowed strategies on the plain path and under the
fixed-grid and the adaptive adjoint; the attention block, whose pinned
values carry a gradient, so the second derivative reaches A^T's values;
GRAND-nl on the per-edge and the windowed plain routes, and the flag that
moves it there; GAT. Tolerances: loss rtol 1e-6, gradients rtol 1e-4 /
atol 1e-6, forward and backward NFE equal. graphax's windowed Pallas
kernels have no second derivative (`pallas_call`'s jvp rule raises), so
on the windowed graph graphax runs its XLA SpMM (the same product), and
the adaptive adjoint, whose state differs between its two routes, is
held on the other graphs."""

import numpy as np
import pytest

from graphax_torch import Trainer, make_sbm_dataset
from graphax_torch.functions.transformer import attention_route
from graphax_torch.train import Config

from torch_surface_helpers import (  # noqa: F401 (one_torch_thread)
    ADJ, BASE, SBM, force, one_torch_thread, step_both,
)

ALL4 = dict(kinetic_energy=1.0, jacobian_norm2=0.1, directional_penalty=0.3,
            total_deriv=0.2)


@pytest.mark.parametrize("strategy,adjoint", [
    ("dense", "plain"), ("dense", "rk4"), ("dense", "adaptive"),
    ("sparse", "plain"), ("sparse", "adaptive"),
    ("windowed", "plain"), ("windowed", "rk4")])
def test_all_rates_step_equals_graphax(strategy, adjoint):
    with force(False):
        tr = step_both(dict(BASE, **ALL4, **ADJ[adjoint]), strategy)
    if adjoint == "adaptive":
        assert tr.bm.get_value() > 8


@pytest.mark.parametrize("strategy", ["sparse", "windowed"])
def test_attention_block_second_order_reaches_its_layer(strategy):
    """The pinned values carry a gradient: the second derivative reaches
    the attention layer through A^T's values."""
    tr = step_both(dict(BASE, block="attention", directional_penalty=0.5,
                        jacobian_norm2=0.1), strategy, qk_scale=0.4)
    assert np.abs(tr.model.block.att_layer.Q.weight.grad.numpy()).max() > 0


@pytest.mark.parametrize("strategy,route", [("sparse", "edge"),
                                            ("windowed", "windowed_plain")])
def test_transformer_second_order_route(strategy, route):
    kw = dict(BASE, function="transformer", directional_penalty=0.5,
              total_deriv=0.2)
    tr = step_both(kw, strategy, qk_scale=0.3)
    cfg, g = tr.cfg, tr.data.graph
    assert attention_route(cfg, g, 16, second_order=True) == route
    assert attention_route(cfg, g, 16) != route or strategy == "windowed"
    k = tr.model.block.func.att.K.weight.grad
    assert np.abs(k.numpy()).max() > 0


@pytest.mark.parametrize("regs,second", [
    (dict(kinetic_energy=0.5), False),
    (dict(kinetic_energy=0.5, directional_penalty=0.5), True)])
def test_only_a_vjp_in_the_rhs_moves_the_route(monkeypatch, regs, second):
    """kinetic_energy alone keeps the usual routes; a regulariser that
    takes the RHS's vjp flags every RHS evaluation of the train step."""
    import graphax_torch.functions.transformer as tf

    seen = set()
    route = tf.attention_route

    def recorded(cfg, graph, d, second_order=False):
        seen.add(second_order)
        return route(cfg, graph, d, second_order)

    monkeypatch.setattr(tf, "attention_route", recorded)
    step_both(dict(BASE, function="transformer", **regs, **ADJ["rk4"]),
              "sparse", qk_scale=0.3)
    assert seen == {second}


def test_gat_step_equals_graphax():
    step_both(dict(BASE, function="GAT", directional_penalty=0.5),
              "sparse")


def test_eval_takes_no_regulariser():
    tr = Trainer(Config(**BASE, **ALL4), make_sbm_dataset(
        **SBM, strategy="sparse", device="cpu"), device="cpu")
    tr.evaluate()
    assert tr.last_eval.nfe == 8


def test_regularised_trainer_three_steps_equal_graphax():
    """graphax's regularised trainer case (tests/test_train.py's split-step
    test: the attention block, rk4, batch norm, kinetic_energy) with the
    dropouts at 0 (the two packages draw different masks): 3 Adam steps
    from the same weights, losses within 1e-5 relative and the weights
    after them within 2e-5 (as tests/test_torch_slice.py's 3 steps)."""
    import jax

    from graphax.data.synthetic import make_sbm_dataset as gx_make_sbm
    from graphax.train import Config as GxConfig
    from graphax.train.loop import Trainer as GxTrainer

    from graphax_torch.utils.transplant import (
        graphax_to_state_dict, load_graphax_params,
    )

    kw = dict(block="attention", function="laplacian", hidden_dim=8,
              heads=2, attention_dim=8, method="rk4", step_size=0.5,
              time=1.0, add_source=True, self_loop_weight=1.0,
              input_dropout=0.0, dropout=0.0, batch_norm=True,
              kinetic_energy=0.01, lr=0.02, no_early=True)
    sbm = dict(num_nodes=48, num_classes=3, num_features=6, p_in=0.2,
               p_out=0.02, seed=4)
    gtr = GxTrainer(GxConfig(**kw), gx_make_sbm(**sbm))
    state = gtr.init_state(0)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    tr = Trainer(Config(**kw), make_sbm_dataset(**sbm, device="cpu"),
                 device="cpu")
    load_graphax_params(tr.model, to_np(state.params),
                        to_np(state.model_state))
    for _ in range(3):
        state, gx_loss = gtr.train_step(state)
        np.testing.assert_allclose(tr.train_step(), float(gx_loss),
                                   rtol=1e-5)
    want = graphax_to_state_dict(to_np(state.params),
                                 to_np(state.model_state))
    for k, v in tr.model.state_dict().items():
        np.testing.assert_allclose(v.float().numpy(), want[k], rtol=1e-5,
                                   atol=2e-5, err_msg=k)
