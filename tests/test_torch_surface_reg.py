"""The RNODE regularisers of graphax_torch against graphax's, and the
second derivatives of the hand-written kernels' autograd Functions.

graphax's oracle (tests/test_blocks_models.py::test_regularizers_integrate)
runs on the port's block. Each rate at one RHS evaluation equals graphax's
`make_regularized_rhs` (1e-6), and a Trainer step with each rate alone
equals graphax's on the sparse strategy under the rk4 adjoint: loss rtol 1e-6, gradients rtol 1e-4 / atol 1e-6, forward and
backward NFE equal (all four together on every strategy and adjoint:
tests/test_torch_surface_reg_steps.py).

`torch.autograd.gradgradcheck` holds `_SpMM`, `_SDDMM` and the three
windowed Functions in float64 on their plain versions, which round their
sums through f32: central differences of step 1e-2 on these bilinear
maps, tolerance 1e-3."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from graphax.functions import get_function as gx_get_function
from graphax.functions.common import FuncState as GxFuncState
from graphax.functions.regularizers import (
    make_regularized_rhs as gx_make_regularized_rhs,
)
from graphax.train import Config as GxConfig

from graphax_torch.blocks import get_block, make_fstate
from graphax_torch.functions import get_function, prepare_scalars
from graphax_torch.functions.regularizers import (
    REGULARIZER_NAMES, _hutchinson_divergence, init_reg_states,
    make_regularized_rhs, regularization_loss,
)
from graphax_torch.kernels import windowed_spmm as ws
from graphax_torch.kernels.dispatch import attach_windows
from graphax_torch.kernels.spmm import _SDDMM, _SpMM, transpose_values
from graphax_torch.sparse.graph import Graph
from graphax_torch.train import Config

from torch_surface_helpers import (  # noqa: F401 (one_torch_thread)
    ADJ, BASE, one_torch_thread, step_both,
)


# ----------------------------------------------------------------------
# the module
# ----------------------------------------------------------------------

def _toy(n=40, d=4, seed=0):
    rng = np.random.RandomState(seed)
    row, col = rng.randint(0, n, 4 * n), rng.randint(0, n, 4 * n)
    key = np.unique(row * n + col)
    row, col = key // n, key % n
    w = (rng.rand(len(row)) + 0.1).astype(np.float32)
    x = rng.randn(n, d).astype(np.float32)
    return row, col, w, x


def test_regularizers_integrate():
    """graphax's oracle on the port's constant block."""
    cfg = Config(hidden_dim=4, block="constant", function="laplacian",
                 method="euler", step_size=0.25, time=1.0,
                 kinetic_energy=1.0, jacobian_norm2=0.1,
                 self_loop_weight=1.0)
    row, col, w, x = _toy()
    g = Graph.from_edges(row, col, 40, w, edge_buffer_size=len(row) + 8)
    blk = get_block(cfg, 4)
    blk.reset_parameters(torch.Generator().manual_seed(0))
    out = blk(g, torch.from_numpy(x), train=True)
    assert len(out.reg_states) == 2
    assert out.reg_states[0].shape == (40,)
    assert float(out.reg_states[0].detach().min()) >= 0.0
    assert blk(g, torch.from_numpy(x), train=False).reg_states == ()


@pytest.mark.parametrize("names", [(n,) for n in REGULARIZER_NAMES]
                         + [REGULARIZER_NAMES])
def test_rates_equal_graphax(names):
    """(dx, rates) of one evaluation of the regularised laplacian RHS."""
    from graphax.sparse.graph import Graph as GxGraph

    row, col, w, x = _toy()
    cfg = Config(hidden_dim=4, function="laplacian", add_source=True)
    gcfg = GxConfig(hidden_dim=4, function="laplacian", add_source=True)
    gg = GxGraph.from_edges(row, col, 40, w, edge_buffer_size=len(row) + 8)
    gfn = gx_get_function(gcfg, 4)
    gp = gfn.init(jax.random.PRNGKey(0))
    gp["alpha_train"], gp["beta_train"] = jnp.float32(0.3), jnp.float32(-.4)
    from graphax.functions.common import prepare_scalars as gx_scalars
    gp = gx_scalars(gp, gcfg, jnp.float32)
    fs = GxFuncState(graph=gg, x0=jnp.asarray(x) * 0.5)
    aug = gx_make_regularized_rhs(gfn.rhs, names)
    want_dx, want = aug(gp, fs, 0.3, (jnp.asarray(x), ()))

    g = Graph.from_edges(row, col, 40, w, edge_buffer_size=len(row) + 8)
    fn = get_function(cfg, 4)
    with torch.no_grad():
        fn.alpha_train.fill_(0.3)
        fn.beta_train.fill_(-0.4)
    alpha, beta = prepare_scalars(fn, cfg, torch.float32)
    fstate = make_fstate(g, torch.from_numpy(x) * 0.5, train=False, cfg=cfg)
    rhs = make_regularized_rhs(
        lambda t, y: fn.rhs(alpha, beta, fstate, t, y), names)
    dx, *rates = rhs(torch.tensor(0.3), (torch.from_numpy(x),
                                         *init_reg_states(40, names)))
    np.testing.assert_allclose(dx.detach().numpy(), np.asarray(want_dx),
                               rtol=1e-6, atol=1e-7)
    for r, wr in zip(rates, want):
        np.testing.assert_allclose(r.detach().numpy(), np.asarray(wr),
                                   rtol=1e-5, atol=1e-6)


def test_hutchinson_is_eps_j_eps_and_takes_a_generator():
    row, col, w, x = _toy(n=12, d=3)
    g = Graph.from_edges(row, col, 12, w)
    wb = g.edge_weight
    xt = torch.from_numpy(x).requires_grad_(True)
    f = lambda y: torch.tanh(_SpMM.apply(wb, transpose_values(g, wb), y,
                                         g.csr, g.csc))
    dx = f(xt)
    eps = torch.randint(0, 2, (2, 12, 3),
                        generator=torch.Generator().manual_seed(1)) * 2 - 1.0
    jac = torch.autograd.functional.jacobian(f, xt.detach()) \
        .reshape(36, 36)
    want = torch.stack([(e.reshape(-1) * (jac.T @ e.reshape(-1)))
                        .reshape(12, 3).sum(-1) for e in eps]).mean(0)
    got = _hutchinson_divergence(dx, xt, eps=eps)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    a = _hutchinson_divergence(dx, xt,
                               generator=torch.Generator().manual_seed(3))
    b = _hutchinson_divergence(dx, xt,
                               generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        _hutchinson_divergence(dx, xt)


def test_regularization_loss():
    states = (torch.tensor([1.0, 3.0]), torch.tensor([2.0, 2.0]))
    assert float(regularization_loss(states, (0.5, 2.0))) == 5.0


# ----------------------------------------------------------------------
# Trainer steps against graphax's
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", REGULARIZER_NAMES)
def test_each_rate_step_equals_graphax(name):
    step_both(dict(BASE, **{name: 0.5}, **ADJ["rk4"]), "sparse")


# ----------------------------------------------------------------------
# second derivatives of the kernels' Functions (plain versions)
# ----------------------------------------------------------------------

GG = dict(eps=1e-2, atol=1e-3, rtol=1e-3)


def _graph(n=14, seed=0):
    row, col, w, _ = _toy(n=n, seed=seed)
    return Graph.from_edges(row, col, n, w, edge_buffer_size=len(row) + 3)


def _rand(*shape, seed=0):
    return torch.tensor(np.random.RandomState(seed).randn(*shape),
                        dtype=torch.float64, requires_grad=True)


def test_spmm_gradgradcheck():
    g = _graph()
    f = lambda wb, x: _SpMM.apply(wb, transpose_values(g, wb.detach()), x,
                                  g.csr, g.csc)
    args = (_rand(g.edge_buffer_size), _rand(14, 3, seed=1))
    assert torch.autograd.gradcheck(f, args, **GG)
    assert torch.autograd.gradgradcheck(f, args, **GG)


def test_sddmm_gradgradcheck():
    g = _graph()
    f = lambda a, b: _SDDMM.apply(a, b, g.csr, g.csc, torch.float64,
                                  g.edge_buffer_size)
    args = (_rand(14, 3), _rand(14, 3, seed=1))
    assert torch.autograd.gradcheck(f, args, **GG)
    assert torch.autograd.gradgradcheck(f, args, **GG)


def test_residual_spmm_gradgradcheck():
    """The windowed residual's layouts map slots through ``perm``."""
    wl = attach_windows(_graph(n=24), window=8, tile=4).windows
    res, res_t = wl.residual, wl.residual_t
    from graphax_torch.kernels.spmm import _transpose_slots
    t2r = _transpose_slots(res, res_t)
    f = lambda wb, x: _SpMM.apply(wb, wb.detach()[t2r], x, res, res_t)
    args = (_rand(res.num_slots), _rand(24, 2, seed=1))
    assert torch.autograd.gradgradcheck(f, args, **GG)


@pytest.mark.parametrize("fn", ["matmul", "slab", "dense"])
def test_windowed_gradgradcheck(fn):
    wl = attach_windows(_graph(n=24), window=8, tile=4).windows
    blocks = _rand(*wl.block_shape)
    if fn == "matmul":
        f = lambda d, x, a: ws._WinMatmul.apply(d, x, wl, a)
        args = (blocks, _rand(24, 3, seed=1), _rand(24, 3, seed=2))
    elif fn == "slab":
        f = lambda d, g: ws._WinBwdSlab.apply(d, g, wl, torch.float64)
        args = (blocks, _rand(24, 3, seed=1))
    else:
        f = lambda g, x: ws._WinBwdDense.apply(g, x, wl, torch.float64)
        args = (_rand(24, 3), _rand(24, 3, seed=1))
    assert torch.autograd.gradcheck(f, args, **GG)
    assert torch.autograd.gradgradcheck(f, args, **GG)


def test_first_order_backward_records_nothing():
    """Without create_graph the backwards run their Functions' forwards
    alone: the gradients carry no graph."""
    g = _graph()
    wb = _rand(g.edge_buffer_size).float().detach().requires_grad_(True)
    x = _rand(14, 3).float().detach().requires_grad_(True)
    y = _SpMM.apply(wb, transpose_values(g, wb.detach()), x, g.csr, g.csc)
    dw, dx = torch.autograd.grad(y.sum(), (wb, x), retain_graph=True)
    assert dw.grad_fn is None and dx.grad_fn is None
    dw2, dx2 = torch.autograd.grad(y.sum(), (wb, x), create_graph=True)
    assert dw2.grad_fn is not None and dx2.grad_fn is not None
    torch.testing.assert_close(dw, dw2.detach())
    torch.testing.assert_close(dx, dx2.detach())
