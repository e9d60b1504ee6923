"""Explicit and implicit Adams and the norm overrides of graphax_torch.ode
against graphax.ode, and the solver-comparison driver.

graphax's own oracles (tests/test_ode_solvers.py: AB4/AM4 accuracy and
order, the oscillator with an observer, the RK4 prologue's NFE, a norm_fn
that forces smaller steps) run on the port's solvers; each solve is also
held to graphax's on the same problem: NFE equal and y(T) to 1e-6
relative (f32 sums in another order), gradients through the steps to 1e-5.
A Trainer step under each Adams method matches graphax's (loss 1e-6,
gradients rtol 1e-4 / atol 1e-6, NFE equal), with the plain path and with
the fixed-grid adjoint."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.data.synthetic import make_sbm_dataset as gx_make_sbm
from graphax.kernels.dispatch import attach_tiles
from graphax.ode import odeint as gx_odeint
from graphax.train import Config as GxConfig
from graphax.train.loop import Trainer as GxTrainer

from graphax_torch import Trainer, make_sbm_dataset
from graphax_torch.drivers.explicit_implicit import run_experiment
from graphax_torch.ode import Observer, odeint, odeint_adjoint
from graphax_torch.train import Config
from graphax_torch.utils.transplant import (
    graphax_to_state_dict, load_graphax_params,
)

from torch_surface_helpers import one_torch_thread  # noqa: F401 (autouse)

ADAMS = ["explicit_adams", "implicit_adams"]
A6 = (np.random.RandomState(0).randn(6, 6) * 0.3).astype(np.float32)


def exp_decay(t, y):
    return -y


# ----------------------------------------------------------------------
# graphax's oracles on the port
# ----------------------------------------------------------------------

@pytest.mark.parametrize("method", ADAMS)
def test_adams_accuracy(method):
    res = odeint(exp_decay, torch.ones(4), 0.0, 1.0, method=method,
                 step_size=0.025)
    np.testing.assert_allclose(res.y.numpy(), np.exp(-1.0) * np.ones(4),
                               rtol=1e-6)
    assert res.success


@pytest.mark.parametrize("method", ADAMS)
def test_adams_order_four(method):
    exact = np.exp(-2.0)

    def err(dt):
        r = odeint(exp_decay, torch.ones(2), 0.0, 2.0, method=method,
                   step_size=dt)
        return float(np.abs(r.y.numpy() - exact).max())

    assert err(0.1) < err(0.2) / 8


def test_adams_observer_and_oscillator():
    seen = Observer(init=torch.tensor(-1.0),
                    update=lambda c, t, y: torch.maximum(c, t))
    res = odeint(lambda t, y: torch.stack([y[1], -y[0]]),
                 torch.tensor([1.0, 0.0]), 0.0, 3.1, method="implicit_adams",
                 step_size=0.05, observer=seen)
    np.testing.assert_allclose(res.y.numpy(), [np.cos(3.1), -np.sin(3.1)],
                               atol=1e-5)
    assert float(res.observer) > 3.0


def test_adams_nfe_prologue():
    n = 20
    res = odeint(exp_decay, torch.ones(4), 0.0, 2.0, method="explicit_adams",
                 step_size=0.1)
    assert res.nfe == 3 * 4 + (n - 3) * 1 and res.steps == n
    res_i = odeint(exp_decay, torch.ones(4), 0.0, 2.0,
                   method="implicit_adams", step_size=0.1)
    assert res_i.nfe == 3 * 4 + (n - 3) * 2


def test_norm_fn_override_changes_controller():
    f = lambda t, y: torch.sin(3 * t) * y
    base = odeint(f, torch.ones(16), 0.0, 4.0, method="dopri5", rtol=1e-6,
                  atol=1e-6)
    hard = odeint(f, torch.ones(16), 0.0, 4.0, method="dopri5", rtol=1e-6,
                  atol=1e-6,
                  norm_fn=lambda v: 10.0 * torch.sqrt(torch.mean(v * v)))
    np.testing.assert_allclose(base.y.numpy(), hard.y.numpy(), rtol=1e-4)
    assert hard.nfe > base.nfe


# ----------------------------------------------------------------------
# against graphax
# ----------------------------------------------------------------------

PROBLEMS = {
    "exp_decay": (lambda t, y: -y, lambda t, y: -y,
                  np.ones(3, np.float32), 2.0),
    "sin_t": (lambda t, y: jnp.sin(t) * y, lambda t, y: torch.sin(t) * y,
              np.linspace(0.5, 1.5, 8).astype(np.float32), 3.0),
    "tanh_mix": (lambda t, y: 1.3 * jnp.tanh(y @ A6.T) - 0.5 * y,
                 lambda t, y: 1.3 * torch.tanh(y @ torch.from_numpy(A6).T)
                 - 0.5 * y, np.ones(6, np.float32), 2.0),
}


@pytest.mark.parametrize("step", [0.25, 0.1, 0.7])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("method", ADAMS)
def test_adams_equals_graphax(method, name, step):
    fj, ft, y0, t1 = PROBLEMS[name]
    want = gx_odeint(fj, jnp.asarray(y0), 0.0, t1, method=method,
                     step_size=step)
    got = odeint(ft, torch.from_numpy(y0), 0.0, t1, method=method,
                 step_size=step)
    assert got.nfe == int(want.nfe) and got.steps == int(want.steps)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("method", ADAMS)
def test_adams_gradient_through_steps_equals_graphax(method):
    a = jnp.asarray(A6)

    def gx_loss(scale):
        res = gx_odeint(lambda t, y: scale * jnp.tanh(y @ a.T) - 0.5 * y,
                        jnp.ones(6), 0.0, 2.0, method=method, step_size=0.2)
        return jnp.sum(res.y ** 2)

    want = jax.value_and_grad(gx_loss)(jnp.float32(1.3))
    s = torch.tensor(1.3, requires_grad=True)
    at = torch.from_numpy(A6)
    res = odeint(lambda t, y: s * torch.tanh(y @ at.T) - 0.5 * y,
                 torch.ones(6), 0.0, 2.0, method=method, step_size=0.2)
    loss = torch.sum(res.y ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want[0]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(s.grad), float(want[1]), rtol=1e-5)


@pytest.mark.parametrize("method", ADAMS)
def test_adams_tuple_state_and_adjoint(method):
    """A tuple state through Adams, and Adams as the adjoint's forward and
    backward method: gradients against autograd through the steps."""
    k = torch.tensor(0.7, requires_grad=True)
    y0 = (torch.ones(5), torch.full((3,), 2.0))
    f = lambda p, t, y: (-p[0] * y[0], -0.5 * p[0] * y[1])
    res = odeint_adjoint(f, (k,), y0, 0.0, 1.5, method=method,
                         step_size=0.05, adjoint_method=method,
                         adjoint_step_size=0.05)
    (sum(torch.sum(t ** 2) for t in res.y)).backward()
    ref = k.detach().clone().requires_grad_(True)
    plain = odeint(lambda t, y: f((ref,), t, y), y0, 0.0, 1.5, method=method,
                   step_size=0.05)
    (sum(torch.sum(t ** 2) for t in plain.y)).backward()
    np.testing.assert_allclose(float(k.grad), float(ref.grad), rtol=1e-4)
    assert res.adjoint.nfe == plain.nfe


@pytest.mark.parametrize("tol", [1e-3, 1e-5])
def test_norm_fn_equals_graphax(tol):
    """The overridden norm takes graphax's steps (at tolerances whose error
    estimates lie above f32 rounding, as tests/test_torch_ode.py's); the
    step sizes differ in their last bits (sin of an f32 time in another
    library), so y(T) agrees to a tenth of the solve's tolerance."""
    fj = lambda t, y: jnp.sin(3 * t) * y
    ft = lambda t, y: torch.sin(3 * t) * y
    want = gx_odeint(fj, jnp.ones(16), 0.0, 4.0, method="dopri5", rtol=tol,
                     atol=tol,
                     norm_fn=lambda v: 10.0 * jnp.sqrt(jnp.mean(v * v)))
    got = odeint(ft, torch.ones(16), 0.0, 4.0, method="dopri5", rtol=tol,
                 atol=tol,
                 norm_fn=lambda v: 10.0 * torch.sqrt(torch.mean(v * v)))
    assert got.nfe == int(want.nfe) and got.steps == int(want.steps)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y),
                               rtol=tol / 10)


def test_adjoint_norm_fn_changes_backward_controller():
    k = torch.tensor(0.7, requires_grad=True)
    f = lambda p, t, y: -p[0] * torch.sin(3 * t) * y
    nfe = []
    for norm in (None, lambda v: 10.0 * torch.sqrt(torch.mean(v * v))):
        res = odeint_adjoint(f, (k,), torch.ones(8), 0.0, 2.0,
                             method="dopri5", rtol=1e-6, atol=1e-6,
                             adjoint_method="dopri5", adjoint_rtol=1e-6,
                             adjoint_atol=1e-6, adjoint_norm_fn=norm)
        torch.sum(res.y).backward()
        nfe.append(res.adjoint.nfe)
    assert nfe[1] > nfe[0]


# ----------------------------------------------------------------------
# the Trainer under Adams
# ----------------------------------------------------------------------

BASE = dict(dataset="sbm", function="laplacian", block="constant",
            hidden_dim=16, time=2.0, step_size=0.25, batch_norm=False,
            optimizer="sgd", lr=1.0, decay=0.0, input_dropout=0.0,
            dropout=0.0, no_early=True, add_source=True)
SBM = dict(num_nodes=120, num_classes=3, num_features=12, seed=2)


def _train_step_both(**over):
    kw = dict(BASE, **over)
    gdata = gx_make_sbm(**SBM)
    gdata = dataclasses.replace(gdata, graph=dataclasses.replace(
        attach_tiles(gdata.graph), strategy="tiled"))
    gtr = GxTrainer(GxConfig(**kw), gdata)
    state = gtr.init_state()
    fn = state.params["block"]["func"]
    fn["alpha_train"] = jnp.asarray(0.3)
    fn["beta_train"] = jnp.asarray(-0.4)
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
    np.testing.assert_allclose(pt_loss, float(gx_loss), rtol=1e-6)
    assert tr.fm.get_value() == gtr.fm.get_value()
    assert tr.bm.get_value() == gtr.bm.get_value()
    for k, p in tr.model.named_parameters():
        g = np.zeros(tuple(p.shape), np.float32) if p.grad is None \
            else p.grad.numpy()
        np.testing.assert_allclose(g, before[k] - after[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    return tr


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("method", ADAMS)
def test_trainer_step_under_adams_equals_graphax(method, adjoint):
    tr = _train_step_both(method=method, adjoint=adjoint,
                          adjoint_method="rk4", adjoint_step_size=0.5)
    assert tr.fm.get_value() == 12 + 5 * (2 if method == "implicit_adams"
                                         else 1)


def test_explicit_implicit_driver(tmp_path):
    """graphax's solver comparison on a small SBM: the five methods, one
    step size, one epoch; a record each with graphax's keys, pickled."""
    data = make_sbm_dataset(num_nodes=80, num_classes=3, num_features=8,
                            seed=1, device="cpu")
    out = run_experiment("sbm", step_sizes=(0.5,), epochs=1,
                         results_dir=str(tmp_path), device="cpu", data=data,
                         base_overrides=dict(hidden_dim=8))
    assert sorted(m for m, _, _ in out) == sorted(
        ["euler", "rk4", "dopri5", "explicit_adams", "implicit_adams"])
    nfe = {m: rec["nfes"][0] for (m, _, _), rec in out.items()}
    # 3 / 0.5 = 6 steps: RK4's prologue then 3 multistep steps
    assert nfe["explicit_adams"] == 12 + 3
    assert nfe["implicit_adams"] == 12 + 6
    assert nfe["euler"] == 6 and nfe["rk4"] == 24
    assert len(list(tmp_path.glob("sbm_*_stepsize_*_run_0.pickle"))) == 5
    for rec in out.values():
        assert np.isfinite(rec["losses"]).all()
