"""graphax_torch.ode against graphax.ode on the problems of
tests/test_ode_solvers.py.

The controllers run the same f32 arithmetic. Where the local error
estimates lie well above f32 rounding (the tolerance pairs of
``ABOVE_NOISE``, which include the ogbn-arxiv preset's rtol 1.1e-5 / atol
1.1e-3), accepted steps and NFE must be equal and y(T) agree to 1e-6
relative (f32 sums in another order; XLA may contract a*b+c into one FMA
where PyTorch rounds twice), 5e-5 absolute where the RHS has a tanh. At tolerances so tight that the first steps'
error estimates are rounding noise, one borderline accept/reject can go
either way: there the accepted steps agree within one and y(T) to 1e-5.
Adjoint gradients agree to 1e-5 relative; the backward NFE is equal."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.ode import odeint as gx_odeint
from graphax.ode import odeint_adjoint as gx_odeint_adjoint
from graphax.ode import last_adjoint_bwd_nfe, reset_adjoint_bwd_nfe

from graphax_torch.ode import odeint, odeint_adjoint

A6 = (np.random.RandomState(0).randn(6, 6) * 0.3).astype(np.float32)

# name -> (jax rhs, torch rhs, y0, t1)
PROBLEMS = {
    "exp_decay": (lambda t, y: -y, lambda t, y: -y,
                  np.ones(3, np.float32), 2.0),
    "sin_t": (lambda t, y: jnp.sin(t) * y, lambda t, y: torch.sin(t) * y,
              np.linspace(0.5, 1.5, 8).astype(np.float32), 3.0),
    "logistic": (lambda t, y: y * (1 - y), lambda t, y: y * (1 - y),
                 np.asarray([0.1], np.float32), 4.0),
    "tanh_mix": (lambda t, y: 1.3 * jnp.tanh(y @ A6.T) - 0.5 * y,
                 lambda t, y: 1.3 * torch.tanh(y @ torch.from_numpy(A6).T)
                 - 0.5 * y,
                 np.ones(6, np.float32), 2.0),
}


def _both(name, method, **kw):
    fj, ft, y0, t1 = PROBLEMS[name]
    rj = gx_odeint(fj, jnp.asarray(y0), 0.0, t1, method=method,
                   differentiable=False, **kw)
    rt = odeint(ft, torch.from_numpy(y0), 0.0, t1, method=method, **kw)
    return rj, rt


# XLA's CPU tanh is its own approximation, a few f32 ulps from libm's;
# over a solve on [0, 2] that moves y(T) of ``tanh_mix`` by up to 3e-5
TANH_ATOL = 5e-5
ABOVE_NOISE = [(1e-4, 1e-4), (1.1e-5, 1.1e-3), (1e-5, 1e-4), (1e-3, 1e-5)]


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("method", ["dopri5", "adaptive_heun", "bosh3"])
@pytest.mark.parametrize("rtol,atol", ABOVE_NOISE)
def test_adaptive_matches_graphax(name, method, rtol, atol):
    rj, rt = _both(name, method, rtol=rtol, atol=atol, max_nfe=5000)
    assert rt.steps == int(rj.steps)
    assert rt.nfe == int(rj.nfe)
    assert rt.success == bool(rj.success)
    np.testing.assert_allclose(rt.y.numpy(), np.asarray(rj.y), rtol=1e-5,
                               atol=TANH_ATOL)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("method", ["dopri5", "bosh3"])
def test_adaptive_at_the_noise_floor_agrees_within_one_step(name, method):
    rj, rt = _both(name, method, rtol=1e-7, atol=1e-9, max_nfe=5000)
    assert abs(rt.steps - int(rj.steps)) <= 1
    assert rt.success and bool(rj.success)
    np.testing.assert_allclose(rt.y.numpy(), np.asarray(rj.y), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("method,step", [("rk4", 0.1), ("rk4", 0.3),
                                         ("euler", 0.05), ("midpoint", 0.25)])
def test_fixed_grid_matches_graphax(name, method, step):
    rj, rt = _both(name, method, step_size=step)
    assert rt.nfe == int(rj.nfe) and rt.steps == int(rj.steps)
    np.testing.assert_allclose(rt.y.numpy(), np.asarray(rj.y), rtol=1e-6,
                               atol=1e-6)


def test_max_nfe_budget_halts_like_graphax():
    fj = lambda t, y: -2000.0 * (y - jnp.cos(t))
    ft = lambda t, y: -2000.0 * (y - torch.cos(t))
    rj = gx_odeint(fj, jnp.asarray([0.0]), 0.0, 10.0, method="dopri5",
                   rtol=1e-9, atol=1e-11, max_nfe=30, differentiable=False)
    rt = odeint(ft, torch.zeros(1), 0.0, 10.0, method="dopri5", rtol=1e-9,
                atol=1e-11, max_nfe=30)
    assert not rt.success and not bool(rj.success)
    assert rt.nfe == int(rj.nfe) and rt.steps == int(rj.steps)


def test_tuple_state_matches_graphax_pytree():
    rj = gx_odeint(lambda t, y: (-y[0], jnp.sin(t) * y[1]),
                   (jnp.ones((2, 3)), jnp.linspace(0.1, 1.0, 5)), 0.0, 1.5,
                   method="dopri5", rtol=1e-6, atol=1e-8,
                   differentiable=False)
    rt = odeint(lambda t, y: (-y[0], torch.sin(t) * y[1]),
                (torch.ones(2, 3), torch.linspace(0.1, 1.0, 5)), 0.0, 1.5,
                method="dopri5", rtol=1e-6, atol=1e-8)
    assert rt.steps == int(rj.steps) and rt.nfe == int(rj.nfe)
    for a, b in zip(rt.y, rj.y):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_bf16_state_matches_graphax():
    """bf16 state, f32 stage arithmetic: graphax rounds the same values."""
    a = np.random.RandomState(1).randn(16, 16).astype(np.float32) * 0.2
    y0 = np.random.RandomState(2).randn(16).astype(np.float32)
    fj = lambda t, y: (jnp.asarray(a).astype(y.dtype) @ y) - y
    ft = lambda t, y: (torch.from_numpy(a).to(y.dtype) @ y) - y
    rj = gx_odeint(fj, jnp.asarray(y0).astype(jnp.bfloat16), 0.0, 2.0,
                   method="dopri5", rtol=1e-5, atol=1e-3,
                   differentiable=False)
    rt = odeint(ft, torch.from_numpy(y0).to(torch.bfloat16), 0.0, 2.0,
                method="dopri5", rtol=1e-5, atol=1e-3)
    assert rt.y.dtype == torch.bfloat16
    assert rt.steps == int(rj.steps) and rt.nfe == int(rj.nfe)
    np.testing.assert_allclose(rt.y.float().numpy(),
                               np.asarray(rj.y, np.float32), rtol=2 ** -7,
                               atol=2e-3)


def test_gradients_through_the_loop():
    s = torch.tensor(1.0, requires_grad=True)
    res = odeint(lambda t, y: -s * y, torch.ones(()), 0.0, 1.0,
                 method="dopri5")
    res.y.backward()
    np.testing.assert_allclose(float(s.grad), -np.exp(-1.0), rtol=1e-4)


@pytest.mark.parametrize("method,adj,ast", [
    ("dopri5", "dopri5", 1.0), ("dopri5", "rk4", 0.25),
    ("dopri5", "adaptive_heun", 1.0), ("rk4", "rk4", 0.5)])
def test_adjoint_matches_graphax(method, adj, ast):
    a = np.random.RandomState(3).randn(5, 5).astype(np.float32) * 0.4
    y0 = np.random.RandomState(4).randn(5).astype(np.float32)
    kw = dict(method=method, rtol=1e-6, atol=1e-8, step_size=0.5,
              adjoint_method=adj, adjoint_rtol=1e-6, adjoint_atol=1e-8,
              adjoint_step_size=ast)

    def fj(p, t, y):
        return p["s"] * jnp.tanh(p["a"] @ y) - p["k"] * y

    def loss_j(p, y):
        r = gx_odeint_adjoint(fj, p, y, 0.0, 1.5, **kw)
        return jnp.sum(r.y ** 2)

    pj = {"a": jnp.asarray(a), "k": jnp.asarray(0.7), "s": jnp.asarray(1.3)}
    reset_adjoint_bwd_nfe()
    gp, gy = jax.grad(loss_j, argnums=(0, 1))(pj, jnp.asarray(y0))
    # the meter is written by an unordered host callback: wait for it
    jax.block_until_ready((gp, gy))
    jax.effects_barrier()
    bwd_nfe = last_adjoint_bwd_nfe()

    pt = [torch.tensor(a, requires_grad=True),
          torch.tensor(0.7, requires_grad=True),
          torch.tensor(1.3, requires_grad=True)]
    yt = torch.tensor(y0, requires_grad=True)

    def ft(p, t, y):
        return p[2] * torch.tanh(p[0] @ y) - p[1] * y

    r = odeint_adjoint(ft, pt, yt, 0.0, 1.5, **kw)
    (r.y ** 2).sum().backward()
    assert r.adjoint.nfe == bwd_nfe
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gy), rtol=1e-5,
                               atol=1e-7)
    for t_, key in zip(pt, ("a", "k", "s")):
        np.testing.assert_allclose(t_.grad.numpy(), np.asarray(gp[key]),
                                   rtol=1e-5, atol=1e-7)


def test_adjoint_only_differentiates_what_needs_it():
    y0 = torch.ones(3, requires_grad=True)
    k = torch.tensor(0.5)                       # needs no gradient
    r = odeint_adjoint(lambda p, t, y: -p[0] * y, [k], y0, 0.0, 1.0,
                       method="dopri5", adjoint_method="rk4",
                       adjoint_step_size=0.1)
    r.y.sum().backward()
    np.testing.assert_allclose(y0.grad.numpy(), np.exp(-0.5) * np.ones(3),
                               rtol=1e-5)
    assert k.grad is None
